"""Edge-list → ``.lux`` converter CLI, the counterpart of
``tools/converter.py``.

Same interface as the reference tool (tools/converter.cc:16-70):

    python -m lux_tpu_torch.tools.converter -nv NV -ne NE \\
        -input edges.txt -output g.lux [-weighted]

``-weighted`` reads 3-column (src dst weight) inputs. The conversion is
numpy (:func:`lux_tpu_torch.graph.format.convert_edge_list`); the output
is byte-identical to the JAX package's converter.
"""

from __future__ import annotations

import argparse
import sys
import time

from lux_tpu_torch.graph.format import convert_edge_list


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                prefix_chars="-")
    p.add_argument("-nv", type=int, required=True, help="number of vertices")
    p.add_argument("-ne", type=int, required=True, help="number of edges")
    p.add_argument("-input", required=True,
                   help="text edge list (src dst [w])")
    p.add_argument("-output", required=True, help="output .lux path")
    p.add_argument("-weighted", action="store_true")
    args = p.parse_args(argv)
    print(
        f"nv = {args.nv} ne = {args.ne} input = {args.input} "
        f"output = {args.output}"
    )
    t0 = time.time()
    convert_edge_list(
        args.input, args.output, args.nv, args.ne, weighted=args.weighted
    )
    print(f"converted in {time.time() - t0:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
