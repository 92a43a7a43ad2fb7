"""stage1_roofline: % of the int8 stage 1's bound that its device time
reaches (``pool/compute.py _stage1_flat`` -> ``kernels/quant_topk``).

Counted from the work, not from the kernel that does it: every query's
distance to every valid row of the flat int8 view, 2 * B * N_valid * D
operations, over the dense bf16 tensor-core peak (an exact product can
be split onto bf16 tensor cores, so no exact implementation reads above
it); or, if larger, its bytes over the HBM peak: the int8 codes, the
float32 group scales and the queries read once, the top-m distances and
ids written once.  The device time is that of every operation launched
inside the program's ``compute.stage1_flat`` spans in the profiled
window."""
from bench.yardstick import peaks


def bound_s(B: int, n_valid: int, layout: dict, m: int) -> float:
    D, group = layout["dim"], layout["quant_group"]
    ops = 2.0 * B * n_valid * D
    nbytes = (n_valid * D + n_valid * (D // group) * 4 + B * D * 4
              + B * m * 8)
    return max(ops / peaks.BF16_FLOPS_S, nbytes / peaks.HBM_BYTES_S)


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.layout.get("quant_group"):
        return None
    dev_s = t.layer_device_s("compute.stage1_flat")
    calls = [sp for sp in t.spans if sp["name"] == "compute.stage1_flat"]
    if not dev_s or not calls:
        return None
    m = ctx.layout["rerank_m"]
    work = sum(bound_s(sp["attrs"]["B"], sp["attrs"]["rows"], ctx.layout, m)
               for sp in calls)
    return 100.0 * work / dev_s
