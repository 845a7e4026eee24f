"""Process start to the first timed sample: interpreter and imports, CUDA
initialisation, the kernel library (built into rsem_tpu_torch/_build/ on a
checkout's first run, loaded after), the annotation and samples made on the
card and copied to host memory, and one warm pass over each distinct
sample."""


def read(ctx):
    return ctx.setup_s
