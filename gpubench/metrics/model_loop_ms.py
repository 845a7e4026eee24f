"""Host time of the model-update loop less the host reads inside it, per
traced sample: the self time of the program's `rsem.em.model_loop` span
(PreIdx's plan and build, the fused loop's data and enqueued rounds; the
statistics' read is an `rsem.sync` inside it), under the profiler."""

from gpubench.program_spans import median_over_samples


def read(ctx):
    return median_over_samples(ctx, lambda t, _k: 1e3 * sum(
        n.self_seconds() for n in t.walk() if n.name == "rsem.em.model_loop")
        or None)
