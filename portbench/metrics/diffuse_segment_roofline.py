"""diffuse_segment_roofline: K1's share of its roofline: ~30 FLOP a pixel
and FED step on every octave of every image sent in the window (f32 at
67 TFLOP/s; each segment's level read and written once at 3.35 TB/s) over
K1's traced device time."""
from portbench import roofline


def read(ctx):
    tr, w = ctx.get("trace"), ctx["work"]
    if tr is None or not w["images"]:
        return None
    work = roofline.diffuse_segment_work(w["images"], w["height"], w["width"], w["octaves"])
    return roofline.share(work, tr.kernel_s("diffuse_fused"))
