"""match_top2_roofline: K4's share of its roofline: every valid query
keypoint row sent in the window against every landmark (bf16 products at
989 TFLOP/s; bytes at 3.35 TB/s) over K4's traced device time."""
from portbench import roofline


def read(ctx):
    tr, w = ctx.get("trace"), ctx["work"]
    if tr is None or not w["query_rows"]:
        return None
    return roofline.share(roofline.match_top2_work(w["query_rows"], w["landmarks"]),
                          tr.kernel_s("match_top2"))
