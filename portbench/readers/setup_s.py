"""Process start to the first timed call: imports, CUDA's start, the kernel
library's build or load, weights and traffic made, the metric built and
every shape of the traffic warmed up."""


def read(run):
    return run.setup_s
