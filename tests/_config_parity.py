"""The port's ``ModelConfig`` held to the reference's: every field the
reference's config has, with its value, and each field of the port's own
(``norm_eps``, the μP multipliers, ``attention_multiplier``,
``ssm_gated_norm``) at its default, which is the arithmetic of a
reference configuration."""
import dataclasses


def config_parity(got, want):
    """``(got's fields, the fields it must have)``, to compare with ``==``:
    ``want``'s, and each field ``want`` lacks at its default."""
    mine, ref = dataclasses.asdict(got), dataclasses.asdict(want)
    own = {f.name: f.default for f in dataclasses.fields(got)
           if f.name not in ref}
    return mine, {**ref, **own}
