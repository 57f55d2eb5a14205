#!/usr/bin/env python3
"""Plants faults in a copy of K2's, K4's and K6's tensor-core BPTT and shows
which of ``chip_smoke.py``'s checks each one fails.

    python3 scripts/torch_bwd_mutants.py [--workdir DIR]

Each fault is one edit of ``csrc/lstm_bwd_cluster.cuh`` in a copy of the
port and of ``chip_smoke.py`` under ``--workdir`` (by default a new
directory under the temporary directory; the checkout is never edited):
a rank left out of the reduce-scatter, the last or the first k-tile of the
product dropped, and the last n-tile of the product not written. The copy
takes the checkout's libraries of the sources that do not include that
header and builds the two that do; then K2 (``lstm_bwd_fused``), K6
(``bilstm_pool_bwd_fused``) and K4 (``bilstm_bwd_fused``, full cotangent
streams at the stream dtype) run in bf16 on the cluster route at the
smoke's shapes (rows 16 and 512), on the smoke's inputs, and each is held
against its plain version with the smoke's own ``compare`` at ``BF16_TOL`` and
``share_check`` at ``BWD_BF16_SHARE``. The unedited kernel runs the same
checks first. One JSON line per check: whether each passes, the max abs
error and the largest share of an output's largest |value|; then the
card's name and power limit. Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "dinunet_implementations_tpu_torch"
HEADER = Path(PACKAGE) / "csrc" / "lstm_bwd_cluster.cuh"
# the sources that include HEADER: rebuilt in each copy
REBUILT = ("lstm_bwd", "bilstm_bwd")
# name -> (the text in HEADER, what the copy has in its place)
MUTANTS = {
    "reduce_skips_last_rank": ("    if (q < C) acc += v[q];", "    if (q < C - 1) acc += v[q];"),
    "product_drops_last_k_tile": ("for (int kt = 0; kt < KT; ++kt) {",
                                  "for (int kt = 0; kt < KT - 1; ++kt) {"),
    "product_drops_first_k_tile": ("for (int kt = 0; kt < KT; ++kt) {",
                                   "for (int kt = 1; kt < KT; ++kt) {"),
    "product_misses_last_n_tile": ("const bool second = 2 * pr + 1 < NT;",
                                   "const bool second = 2 * pr + 2 < NT;"),
}


def checks() -> None:
    """The bf16 checks of K2, K6 and K4 on the cluster route, run inside a
    copy (its root first on ``sys.path``)."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from dinunet_implementations_tpu_torch.ops import bilstm_cuda as bc
    from dinunet_implementations_tpu_torch.ops import lstm_cuda as lc

    if not Path(lc.__file__).is_relative_to(Path.cwd()):
        raise SystemExit(f"the checks import {lc.__file__}, not the copy's")
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(5)
    for rows in cs.BWD_ROWS:
        k2 = cs.bwd_args(torch, lc, rows, bf, g)
        k6 = cs.pool_bwd_args(torch, bc, rows, bf, g)
        k4 = cs.bidir_bwd_args(torch, bc, cs.bidir_args(torch, rows, g), bf, g, const=False)
        cases = (
            ("lstm_bwd", lc.device_bwd_geometry("cuda", rows, cs.H, bf),
             lambda: cs.split_bwd(lc.lstm_bwd_fused(*k2, bf)),
             lambda: cs.split_bwd(lc.lstm_bwd_plain(*k2, bf)), cs.BWD_OUTPUTS),
            ("bilstm_pool_bwd", bc.device_bidir_bwd_geometry("cuda", rows, cs.H, bf),
             lambda: bc.bilstm_pool_bwd_fused(*k6, bf),
             lambda: bc.bilstm_bwd_plain(*cs.pool_plain_args(k6), bf), cs.BIDIR_BWD_OUTPUTS),
            ("bilstm_bwd", bc.device_k4_geometry("cuda", rows, cs.H, bf),
             lambda: bc.bilstm_bwd_fused(*k4, bf), lambda: bc.bilstm_bwd_plain(*k4, bf),
             cs.BIDIR_BWD_OUTPUTS),
        )
        for name, geo, fused, plain, names in cases:
            if geo["route"] != "cluster":
                raise SystemExit(f"{name} rows={rows}: the launcher picks {geo['route']}")
            got, want = fused(), plain()
            torch.cuda.synchronize()
            rec = {"kernel": name, "rows": rows, "C": geo["C"], "R": geo["R"]}
            for check, run in (
                    ("bf16_tol", lambda: cs.compare(name, got, want, names, cs.BF16_TOL)),
                    ("bf16_share", lambda: cs.share_check(name, got, want, names,
                                                          cs.BWD_BF16_SHARE))):
                try:
                    run()
                    rec[check] = "passes"
                except SystemExit as e:
                    rec[check] = "fails"
                    rec[f"{check}_message"] = str(e)
            errs = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, want)]
            rec["max_abs_err"] = max(errs)
            rec["max_share"] = max(e / b.float().abs().max().item() for e, b in zip(errs, want))
            print(json.dumps(rec), flush=True)


def copy_tree(dst: Path, mutant: str | None) -> None:
    """The port and chip_smoke.py under ``dst``, HEADER edited for
    ``mutant``, the checkout's libraries of the sources that do not include
    HEADER in the copy's build directory."""
    shutil.copytree(ROOT / PACKAGE, dst / PACKAGE, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    if mutant is not None:
        old, new = MUTANTS[mutant]
        text = (dst / HEADER).read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{mutant}: {old!r} is not once in {HEADER}")
        (dst / HEADER).write_text(text.replace(old, new))
    out = subprocess.run(
        [sys.executable, "-c", f"from {PACKAGE}.ops import _build; print(_build.build_dir())"],
        cwd=dst, capture_output=True, text=True, check=True).stdout.strip()
    build = Path(out)
    build.mkdir(parents=True, exist_ok=True)
    from dinunet_implementations_tpu_torch.ops import _build

    for src in sorted((ROOT / PACKAGE / "csrc").glob("*.cu")):
        if src.stem not in REBUILT:
            shutil.copy2(_build.build_dir() / f"lib{src.stem}.so", build / f"lib{src.stem}.so")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", type=Path, default=None,
                    help="where the copies go (default: a new temporary directory)")
    ap.add_argument("--checks", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.checks:
        checks()
        return 0

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from dinunet_implementations_tpu_torch.ops import _build

    _build.build_all()
    work = args.workdir or Path(tempfile.mkdtemp(prefix="bwd_mutants_"))
    trees = {name: work / (name or "unedited") for name in (None, *MUTANTS)}
    for name, dst in trees.items():
        if dst.exists():
            shutil.rmtree(dst)
        copy_tree(dst, name)
    # build every copy at once, one nvcc per source
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    builds = [subprocess.Popen([sys.executable, "-c", f"from {PACKAGE}.ops import _build; "
                                "_build.build_all()"], cwd=dst, env=env)
              for dst in trees.values()]
    if any([p.wait() != 0 for p in builds]):
        raise SystemExit("a copy failed to build")
    failed = 0
    for name, dst in trees.items():
        out = subprocess.run([sys.executable, str(ROOT / "scripts" / Path(__file__).name),
                              "--checks"], cwd=dst, env=dict(env, PYTHONPATH=str(dst)),
                             capture_output=True, text=True)
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                print(json.dumps({"mutant": name, **json.loads(line)}), flush=True)
        if out.returncode != 0:
            failed += 1
            print(f"{name}: checks exited {out.returncode}\n{out.stderr[-3000:]}", file=sys.stderr)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
