"""fused_ffn's share of its roofline, in %: the sum over the traced
window's calls of each call's least time (operations at the bf16 peak or
compulsory bytes at the memory peak, the larger; counted from the shapes
the benchmark recorded at each call) over the device time of the kernel
``ffn_kernel``.  Nothing when the two disagree on the number of
calls: then the kernel did not run as the calls say."""

KIND, KERNEL = "fused_ffn", "ffn_kernel"


def read(r):
    calls = r.kernels.calls.get(KIND, 0)
    names = [n for n in r.summary.get("device_ops", {})
             if KERNEL in n and (KERNEL != "ffn_kernel"
                                 or "dense_ln" not in n)]
    launched = sum(r.summary["device_counts"][n] for n in names)
    busy = sum(r.summary["device_ops"][n] for n in names)
    if not calls or launched != calls or busy <= 0:
        return None
    return 100.0 * r.kernels.least_s[KIND] / busy
