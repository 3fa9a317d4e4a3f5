"""layout_s: the benchmark's clock around the trainer's construction (the
community layout, the ELL blocks, the exchange plan, the packed state,
the first iterates), ending in a device synchronise."""


def read(run):
    return run["spans"].get("layout")
