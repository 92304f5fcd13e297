"""The host's time to issue a step's forward: the median, over the traced
steps, of the port's ``lfm2.forward`` spans (``LFM2MoEForCausalLM.forward``,
``horovod_tpu_torch.common.timeline``) that start after the window, in
ms.  None for a launched cell (its ranks' spans stay in their processes),
where the port records no spans, where their count is not the traffic's
``trace_steps`` or where the recorder dropped any."""
import statistics


def read(run):
    if run["cell"].chips != 1:
        return None
    try:
        from horovod_tpu_torch.common.timeline import dropped, spans
    except ImportError:
        return None
    fwd = [s for s in spans(run["ranks"][0]["t_window1"] * 1e6)
           if s.name == "lfm2.forward"]
    if dropped() or len(fwd) != int(run["cell"].traffic["trace_steps"]):
        return None
    return statistics.median((s.end_us - s.start_us) / 1e3 for s in fwd)
