"""Command line: ``python -m tpukzg_torch.cli <cmd>`` (counterpart of
``tpukzg/cli.py``).  Every command runs on the card unless ``--device``
names another device (``--device cpu`` runs the plain tensor versions).

  gen-setup  --tau T --n N --out FILE     write an insecure dev SRS (.npz)
  selftest   [--n N]                      commit, prove, verify round trip
  bench      [--n N --k K --reps R]       headline benchmark JSON line
                                          (``tpukzg_torch/bench.py``)
  verify     --setup FILE --blob FILE --commitment HEX --proof HEX
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time


def _cmd_gen_setup(args):
    from tpukzg_torch.kzg.setup import Setup
    from tpukzg_torch.utils.config import KzgConfig

    n = args.n if args.n is not None else KzgConfig.from_env().degree
    s = Setup.generate_insecure(int(args.tau, 0), n, device=args.device)
    s.save(args.out)
    print(f"wrote n={n} SRS to {args.out}")


def _cmd_selftest(args):
    import tpukzg_torch as tt
    from tpukzg_torch.field.mont import R_MOD

    n = args.n
    t0 = time.time()
    ts = tt.generate_insecure_setup(0xDEADBEEF, n, device=args.device)
    rng = random.Random(0x5EED)
    blobs = [b"".join(rng.randrange(R_MOD).to_bytes(32, "big")
                      for _ in range(n)) for _ in range(2)]
    cs = tt.blob_to_kzg_commitment_batch(blobs, ts)
    pfs = tt.compute_blob_kzg_proof_batch(blobs, cs, ts)
    if not tt.verify_blob_kzg_proof_batch(blobs, cs, pfs, ts):
        raise SystemExit("selftest FAILED: valid proofs refused")
    if tt.verify_blob_kzg_proof_batch(blobs, cs, pfs[::-1], ts):
        raise SystemExit("selftest FAILED: swapped proofs accepted")
    print(f"selftest OK (n={n}, {ts.device}, {time.time() - t0:.1f}s)")


def _cmd_bench(args):
    from tpukzg_torch import bench

    bench.main(n=args.n, k=args.k, reps=args.reps, device=args.device)


def _cmd_verify(args):
    import tpukzg_torch as tt

    ts = tt.load_setup_file(args.setup, device=args.device)
    with open(args.blob, "rb") as fh:
        blob = fh.read()
    ok = tt.verify_blob_kzg_proof(blob, bytes.fromhex(args.commitment),
                                  bytes.fromhex(args.proof), ts)
    print(json.dumps({"valid": bool(ok)}))
    sys.exit(0 if ok else 1)


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpukzg_torch")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen-setup", parents=[common],
                       help="generate an insecure dev SRS")
    g.add_argument("--tau", default="0xDEADBEEF")
    g.add_argument("--n", type=int, default=None,
                   help="degree; default from KzgConfig (TPUKZG_DEGREE)")
    g.add_argument("--out", required=True)
    g.set_defaults(fn=_cmd_gen_setup)

    s = sub.add_parser("selftest", parents=[common],
                       help="commit, prove and verify 2 blobs")
    s.add_argument("--n", type=int, default=16)
    s.set_defaults(fn=_cmd_selftest)

    b = sub.add_parser("bench", parents=[common],
                       help="headline benchmark: one JSON line of "
                            "verifications/s (--k 256 --reps 10 is "
                            "bench.py's shape)")
    b.add_argument("--n", type=int, default=4096)
    b.add_argument("--k", type=int, default=64)
    b.add_argument("--reps", type=int, default=3)
    b.set_defaults(fn=_cmd_bench)

    v = sub.add_parser("verify", parents=[common],
                       help="verify one blob proof")
    v.add_argument("--setup", required=True)
    v.add_argument("--blob", required=True)
    v.add_argument("--commitment", required=True)
    v.add_argument("--proof", required=True)
    v.set_defaults(fn=_cmd_verify)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
