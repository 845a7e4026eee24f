"""Host syncs per run_em: the program's counts of its host reads of device
memory (`d2h_reads`) and of its copies to the card that the host waits
for (`h2d_copies`: from pageable memory), over `em_calls`. The counters
run through the whole process, so this is the mean over every run_em of
the run (set-up, window and traced samples: a sample's counts are the
same with the profiler on or off). None where the program keeps no such
counters."""


def read(ctx):
    try:
        from rsem_tpu_torch.utils.timing import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("em_calls"):
        return None
    return (c.get("d2h_reads", 0) + c.get("h2d_copies", 0)) / c["em_calls"]
