"""The bf16 flash kernel's share of its roofline: the least time of the
window's launches (``roofline.flash_work`` from the scoring's shapes, a
causal self-attention a layer, held to the bf16 peak, as many as
``ops.LAUNCHES`` counted) over the device time of the kernels named below
in the trace, in %."""

from portbench import roofline

KERNELS = ("flash_attention_wgmma_kernel",)
COUNTER = "flash_attention_wgmma"


def read(run):
    n = run.launches.get(COUNTER, 0)
    if run.trace is None or n == 0:
        return None
    spent = run.trace.kernel_seconds(KERNELS)
    if spent <= 0:
        return None
    m = run.model
    one = roofline.least_seconds(*roofline.flash_work(int(run.mix["batch"]), int(run.mix["seq_len"]),
                                                      m["n_heads"], m["n_kv_heads"], m["head_dim"], 2))
    return 100.0 * n * one / spent
