"""rbt_midx — build a positional marker index (build_midx equivalent,
src/build_midx.cpp:5-19).

Converts a text marker-position file (lines "<text_pos> <seq> <pos> <allele>")
into the serialized PosMarkers `.midx.npz` used by rbt_locs.
"""

from __future__ import annotations

import argparse
import sys

from rowbowt_tpu import runtime
from rowbowt_tpu.midx import PosMarkers


def main(argv=None):
    p = argparse.ArgumentParser(prog="rbt_midx", description=__doc__)
    p.add_argument("input", help="text marker-position file")
    p.add_argument("output", help="output .midx.npz path")
    args = p.parse_args(argv)
    runtime.init()
    pm = PosMarkers.from_text_file(args.input)
    pm.save(args.output if args.output.endswith(".npz") else args.output + ".npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
