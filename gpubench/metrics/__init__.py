"""One reader per metric, found by the metric's name in BENCHMARK.json.

Each file holds `read(ctx) -> float | None` over the harness's Context, and
a roofline's the names of the kernels whose device time it reads
(`KERNELS`). What a metric is (unit, direction, source, layer, the metric
it moves, its cells) is said in BENCHMARK.json alone.
"""
