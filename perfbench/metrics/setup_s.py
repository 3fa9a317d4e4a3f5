"""setup_s: process start to the first timed step (host clock): CUDA
start, the graph and the partition, the trainer's layout, the checked
and warm steps, and in a fresh checkout the kernels' build."""


def read(run):
    return run["setup_s"]
