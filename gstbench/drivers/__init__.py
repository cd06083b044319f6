"""Drivers: the general code that runs a kind of traffic mix.  A mix file
(``traffic/<name>.json``) names its driver and holds every parameter."""


def argv(flags: dict, paths: dict) -> list:
    """The program's ``-flag`` argument list from a mix's flags (booleans
    as ``-x`` / ``-no_x``) and the run's file paths."""
    out = []
    for k, v in list(flags.items()) + list(paths.items()):
        if v is True:
            out.append(k)
        elif v is False:
            out.append("-no_" + k[1:])
        else:
            out += [k, str(v)]
    return out


def program_model(config: dict, weights: dict, device, use_decoder: bool):
    """The program's model built from ``config``'s encoder and decoder
    groups, holding ``weights`` (the benchmark's, by reference name)."""
    import dataclasses

    from gstbench import weights as wmod
    from gstx_torch.core.config import DecoderConfig, EncoderConfig
    from gstx_torch.models.encdec import GSTVisualDialog

    def build(cls, group):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in (group or {}).items() if k in names})
    model = GSTVisualDialog(build(EncoderConfig, config["encoder"]),
                            build(DecoderConfig, config.get("decoder")),
                            device=device, use_decoder=use_decoder).eval()
    model.load_state_dict(wmod.state_dict_for(model.state_dict().keys(),
                                              weights, use_decoder))
    return model
