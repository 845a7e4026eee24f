"""The benchmark of rsem_tpu_torch, the PyTorch and CUDA port: a harness
driven by data (BENCHMARK.json at the repository's root names its cells,
configurations, traffic mixes and metrics, each in a file of its own here),
a sample generator on the card, and a plain reference that decides whether
what the timed path produced is correct. It imports neither JAX nor the JAX
package."""
