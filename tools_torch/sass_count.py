"""Instructions a pair of a kernel's inner loop, read from its SASS.

    python3 tools_torch/sass_count.py [--tree DIR] [--out-dir DIR]
        [SOURCE:KERNEL:PAIRS ...]

Builds (or loads) the port's library of ``csrc/SOURCE.cu`` from ``--tree``
(default: this checkout), disassembles it with the toolkit's ``cuobjdump
-sass`` and, in the entry function whose name holds KERNEL, takes the
innermost loop that does the kernel's arithmetic: of the backward branches
whose body (branch target to branch) holds no other backward branch, the
one whose body holds the most FFMA, FMUL and FADD. PAIRS is the (query, reference) pairs one pass of that body covers
(the unrolled rows times the thread's queries). The script prints one JSON
object: per kernel the body's instruction count, its opcodes, and
instructions a pair; ``--out-dir`` also keeps each function's SASS.

Without arguments it reads K9 (``knn:knn1_mxu_sweep:64``: 16 rows a group
times 4 queries) and T1 (``knn_variants:nn1_chunked_partial:32``: 8 rows a
step times 4 queries). Needs the CUDA toolkit (``nvcc`` builds the library
where it is missing); no card is used.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT = ("knn:knn1_mxu_sweep:64", "knn_variants:nn1_chunked_partial:32")
#: the port's library of each source, by its ops module
MODULES = {"knn": "knn_cuda", "knn_variants": "knn_variants_cuda",
           "sweep": "sweep_cuda", "tile": "tile_cuda", "skip": "skip_cuda"}
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_FP = ("FFMA", "FMUL", "FADD")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")


def functions(sass: str) -> dict:
    """``cuobjdump -sass`` output → {function name: [(address, opcode,
    operands)]}."""
    out, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            out[name] = []
        elif name is not None:
            m = _LINE.search(ln)
            if m:
                out[name].append((int(m.group(1), 16), m.group(3), m.group(4)))
    return out


def _back_target(addr: int, op: str, args: str):
    """The target of a backward branch at ``addr``, else None."""
    m = re.search(r"0x([0-9a-f]+)", args) if op.startswith("BRA") else None
    return int(m.group(1), 16) if m and int(m.group(1), 16) <= addr else None


def inner_loop(code: list) -> list:
    """The body of the innermost loop (a backward branch whose body holds
    no other) that holds the most fp32 arithmetic: [(address, opcode,
    operands)] from its target to its branch."""
    best, best_fp = [], -1
    for k, (addr, op, args) in enumerate(code):
        target = _back_target(addr, op, args)
        if target is None:
            continue
        body = [c for c in code[:k + 1] if c[0] >= target]
        if any(_back_target(*c) is not None for c in body[:-1]):
            continue
        fp = sum(c[1].split(".")[0] in _FP for c in body)
        if fp > best_fp:
            best, best_fp = body, fp
    return best


def _ptxas(log: str, kernel: str) -> list:
    """ptxas's lines (registers, shared memory, spills) of the entry
    functions whose names hold ``kernel`` (empty: built earlier)."""
    lines, out = log.splitlines(), []
    for k, ln in enumerate(lines):
        if "Compiling entry" in ln and kernel in ln:
            out += [x.replace("ptxas info    :", "").strip() for x in lines[k:k + 4]
                    if "Compiling" in x or "Used" in x or "spill" in x]
    return out


def count(spec: str, out_dir: str | None) -> dict:
    source, kernel, pairs = spec.split(":")
    mod = importlib.import_module(f"libpointmatcher_tpu_torch.ops.{MODULES[source]}")
    lib = mod.LIBRARY
    lib.load()
    sass = subprocess.run([_cuobjdump(), "-sass", str(lib.path())],
                          capture_output=True, text=True, check=True).stdout
    found = {name: code for name, code in functions(sass).items() if kernel in name}
    if not found:
        raise SystemExit(f"no function of {lib.path().name} holds {kernel!r}")
    res = {"ptxas": _ptxas(lib.build_log, kernel)}
    for name, code in found.items():
        body = inner_loop(code)
        ops = collections.Counter(op.split(".")[0] for _, op, _ in body)
        res[name] = {"instructions": len(code), "loop_instructions": len(body),
                     "loop_pairs": int(pairs),
                     "per_pair": len(body) / int(pairs),
                     "loop_opcodes": dict(ops.most_common())}
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"sass_{kernel}.txt"), "w") as f:
                f.write("\n".join(f"{a:05x} {op}{args}" for a, op, args in code) + "\n")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("specs", nargs="*", default=list(DEFAULT),
                    help="SOURCE:KERNEL:PAIRS, e.g. knn:knn1_mxu_sweep:64")
    ap.add_argument("--tree", default=ROOT, help="root of the port to read")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    out = {"tree": os.path.abspath(args.tree),
           "kernels": {spec: count(spec, args.out_dir)
                       for spec in args.specs}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
