"""stencil_cg_roofline.vmem (%): K5 (``ops/stencil_cg_vmem.py``,
``csrc/stencil_cg_vmem.cu``), a whole CG solve in one launch, in the
solves of the matrix-free configuration: its least time over its mean
device time in the traced window. Least time: the larger of bytes over
3.35 TB/s and operations over 67 TFLOP/s, counted from the configuration
alone. Bytes: r0 and x0 read and x written once (3 vectors), and in each
of the itermax - 1 iterations the part of r, p and x (3 vectors) that the
L2 cannot hold read once and written once, since an iteration reads and
updates all three. It is a floor: no K5 moves less. Operations a point:
r0.r0 (2), then an iteration's p-update (2), apply (28 on the 27-point
stencil: 26 adds, a multiply and a subtraction; 8 on the 7-point one),
p.Ap (2) and the r and x updates with r.r (6). Layer: solver loops.
Moves ``solve_ms``. None where the trace holds no K5 launch."""

from harness.roofline import ITEMSIZE, rows, share_pct

KERNELS = ("stencil_cg_vmem_kernel",)
# the H100's L2 cache: 50 MB (NVIDIA H100 data sheet), 52,428,800 B as
# torch.cuda.get_device_properties reads it on the H100 80GB HBM3
L2_BYTES = 52_428_800
APPLY_FLOPS = {27: 28, 7: 8}


def nbytes(cfg: dict) -> int:
    v = rows(cfg) * ITEMSIZE[cfg["vectors"]]
    return 3 * v + (cfg["itermax"] - 1) * 2 * max(0, 3 * v - L2_BYTES)


def flops(cfg: dict) -> int:
    per_iter = 2 + APPLY_FLOPS[cfg["stencil_points"]] + 8
    return (2 + (cfg["itermax"] - 1) * per_iter) * rows(cfg)


def read(ctx):
    return share_pct(ctx, KERNELS, nbytes(ctx.config), flops(ctx.config))
