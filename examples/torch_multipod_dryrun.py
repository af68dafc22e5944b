"""Multi-pod training/serving dry-run for one architecture, on the port:

  PYTHONPATH=src python examples/torch_multipod_dryrun.py --arch mixtral-8x7b

Counts every applicable (shape) cell of the chosen arch on the meta device
and prints its roofline terms on the single-pod (16x16) AND multi-pod
(2x16x16) virtual meshes at the H100's peaks -- the counterpart of
examples/multipod_dryrun.py.  It needs no GPU and allocates nothing.
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.launch import dryrun  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    args = ap.parse_args(argv)
    return dryrun.main(["--arch", args.arch, "--both", "--quiet"])


if __name__ == "__main__":
    raise SystemExit(main())
