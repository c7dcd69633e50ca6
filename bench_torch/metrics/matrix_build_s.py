"""matrix_build_s (s): the configuration's matrix built on the device by
the format's ``from_stencil`` (DIA: ``formats/dia.py``), timed by the
benchmark's own set-up span on the host clock, closed by a synchronise.
Layer: matrix build. Moves ``setup_s``."""


def read(ctx):
    return ctx.spans.get("matrix_build")
