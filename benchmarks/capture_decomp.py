"""Batched + horizon-sweep decomposition capture.

Times the XLA blocked LLT chains (block-tridiagonal and block-arrow)
against the dense Cholesky at real batch sizes and longer horizons -- the
regime where the O(nb s^3) vs O(n^3) asymptotics bite (the MPC case the
reference's structured layer targets, ref
src/decomposition/triBlockDiagLLT.cpp:9-35). Prints one JSON row per
measurement and appends them to ``--out`` if given. Run on the GPU:

    python benchmarks/capture_decomp.py [--configs "nb,s,batch;..."]

Default configs:
    nb=9  s=48 batch=16   -- IK fixture scale
    nb=9  s=48 batch=128  -- batched
    nb=16 s=32 batch=128  -- longer horizon
    nb=32 s=32 batch=64   -- MPC-length horizon (n=1024)
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from jrlqp_tpu.bench.harness import bench_decompositions  # noqa: E402
from jrlqp_tpu.utils.cache import enable_compile_cache  # noqa: E402

DEFAULT = "9,48,16;9,48,128;16,32,128;32,32,64"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default=DEFAULT)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    enable_compile_cache()
    for c in args.configs.split(";"):
        nb, s, batch = (int(v) for v in c.split(","))
        # f64 rows only at the small scale (B n^2 doubles)
        rows = bench_decompositions(nb=nb, s=s, batch=batch,
                                    include_f64=nb * s <= 432 and batch <= 16)
        for r in rows:
            print(json.dumps(r), flush=True)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
