"""The port's hand-written CUDA kernels, a module each with its wrappers.

Each wrapper module registers here the dict in which its wrappers count
their launches and the function that reads its switch (:func:`register`).
Code that has to know every kernel module reads them from here: a CUDA
graph's replay launches kernels without running the wrappers' Python, so
the decode step's capture takes its launches from :func:`launch_counters`
and keys its graphs by :func:`switches`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

_MODULES: List[Tuple[Dict[str, int], Callable[[], bool]]] = []


def register(launches: Dict[str, int], switch: Callable[[], bool]) -> None:
    """Register a wrapper module's launch counter (updated in place) and
    the reader of its switch."""
    _MODULES.append((launches, switch))


def launch_counters() -> List[Dict[str, int]]:
    """Every registered module's launch counter, in the order of import."""
    return [launches for launches, _ in _MODULES]


def switches() -> Tuple[bool, ...]:
    """Every registered module's switch as it stands."""
    return tuple(switch() for _, switch in _MODULES)
