"""The reference's multi-pod dry run (src/repro/launch/dryrun.py): not
ported.

It lowers and compiles every architecture × input shape on the production
meshes with stand-in inputs and reads XLA's memory and cost analyses.  The
port's counterpart, on the meta device (``Model.input_specs`` /
``cache_specs`` and ``sharding.partition``'s rules already give meta
tensors and specs), is ROADMAP A.5 item 2.

    PYTHONPATH=src python -m repro_torch.launch.dryrun   # refuses
"""
from __future__ import annotations


def main(argv=None) -> dict:
    raise NotImplementedError(
        "the meta-device dry run (launch/dryrun.py) is ROADMAP A.5 item 2")


if __name__ == "__main__":
    main()
