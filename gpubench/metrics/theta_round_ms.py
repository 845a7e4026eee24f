"""Host time of the theta loop per round the EM ran to its stop, per
traced sample: the program's `rsem.em.theta_loop` span over the sample's
theta-only rounds (its EMResult.rounds less the model-update rounds, as
the harness keeps them for the rooflines), under the profiler. Rounds
the loop enqueues past the stop are charged to those before it."""

from gpubench.program_spans import median_over_samples


def read(ctx):
    work = ctx.trace.work if ctx.trace is not None else []

    def one(t, k):
        if k >= len(work) or work[k]["theta_rounds"] <= 0:
            return None
        s = t.total("rsem.em.theta_loop")
        return 1e3 * s / work[k]["theta_rounds"] if s > 0 else None

    return median_over_samples(ctx, one)
