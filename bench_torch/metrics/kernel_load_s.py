"""kernel_load_s (s): the seconds the run spent loading the port's kernel
libraries, set-up included: the sum over ``LOADS`` of
``sparsebench_tpu_torch/ops/_build.py`` (hash, nvcc where a library is not
built yet, dlopen), the intervals of its ``load_library`` spans. Layer:
kernel libraries. Moves ``setup_s``. None where the port keeps no such
record."""


def read(ctx):
    try:
        from sparsebench_tpu_torch.ops import _build
    except ImportError:
        return None
    loads = getattr(_build, "LOADS", None)
    if not loads:
        return None
    return sum(load.seconds for load in loads)
