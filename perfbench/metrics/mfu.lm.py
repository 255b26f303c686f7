"""The whole step: the model's operations (twice the multiply-adds of
every linear, the routed experts at top-k, the shared experts, the head
and attention's QK and PV at each token's context, work.py) of the
prompt and output tokens the engine steps after the traced stretch
processed, over those steps' seconds times the H100's dense int8 peak,
in percent."""
from perfbench import readings, work


def read(run):
    spans = readings.steps(run, run.steady_from, run.t_end)
    if not spans:
        return None
    cfg = run.config["sizes"]
    macs = 0
    for s in spans:
        macs += sum(work.lm_prefill_macs(cfg, n)
                    for n in s.attrs["prefill_lens"])
        macs += sum(work.lm_macs_per_token(cfg, c, head=True)
                    for c in s.attrs["decode_ctx"])
    seconds = spans[-1].end - spans[0].start
    return readings.share(2 * macs / work.INT8_OPS_PER_S, seconds)
