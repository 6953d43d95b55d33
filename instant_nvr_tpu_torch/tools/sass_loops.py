"""Counts the instructions of the loops in the port's compiled kernels.

    python -m instant_nvr_tpu_torch.tools.sass_loops [--root ROOT] [KERNEL ...]

Builds (if needed) each named kernel library of ``cuda_build.KERNELS``
(default: knn_blend and knn_topk) of this checkout, or of ROOT's checkout
loaded under another package name as ``kernel_ab`` loads it, disassembles it
with ``cuobjdump -sass`` (beside ``nvcc``) and prints, for each function,
every loop (a branch to a lower address): its address range, its
instruction count, whether it holds no other loop, and the count of each
opcode in it.  Needs the CUDA toolkit, so it runs on the machine with the
card.
"""
from __future__ import annotations

import argparse
import collections
import importlib
import os
import re
import subprocess
import sys

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_\w+):")
_BRA = re.compile(r"\bBRA(?:\.\S+)?\s+(?:`?\(?(\.L_\w+)\)?`?|(0x[0-9a-f]+))")


def parse(sass: str):
    """{function: [(address, text)]} and {function: {label: address}}."""
    funcs, labels = {}, {}
    name, pending = None, []
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            name = m.group(1)
            funcs[name], labels[name], pending = [], {}, []
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for label in pending:
                labels[name][label] = addr
            pending = []
            funcs[name].append((addr, m.group(2).strip()))
    return funcs, labels


def opcode(text: str) -> str:
    """The opcode of an instruction, without its predicate."""
    parts = text.split()
    if parts and parts[0].startswith("@"):
        parts = parts[1:]
    return parts[0] if parts else ""


def loops(insns, labels):
    """[(start, end, [(address, text)])] for every backward branch."""
    out = []
    for addr, text in insns:
        m = _BRA.search(text)
        if not m:
            continue
        target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if target is not None and target <= addr:
            out.append((target, addr, [(a, t) for a, t in insns if target <= a <= addr]))
    return out


def report(lib: str, sass: str) -> None:
    funcs, labels = parse(sass)
    for name, insns in funcs.items():
        found = loops(insns, labels)
        for start, end, body in found:
            inner = not any(s >= start and e <= end and (s, e) != (start, end)
                            for s, e, _ in found)
            ops = collections.Counter(opcode(t) for _, t in body)
            print(f"[sass] lib={lib} function={name} loop=0x{start:04x}-0x{end:04x} "
                  f"instructions={len(body)} innermost={inner} "
                  f"ops={dict(ops.most_common())}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernels", nargs="*", default=["knn_blend", "knn_topk"])
    ap.add_argument("--root", help="another checkout's root (default: this one)")
    args = ap.parse_args(argv)
    if args.root:
        from .kernel_ab import ALIAS, load_other
        load_other(args.root, "knn")
        cuda_build = importlib.import_module(f"{ALIAS}.cuda_build")
    else:
        from .. import cuda_build
    cuda_build.build_libraries(args.kernels)
    cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    for name in args.kernels:
        so = cuda_build.library_path(name)
        sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                              text=True, check=True).stdout
        print(f"[sass] lib={name} path={so}", flush=True)
        report(name, sass)
    return 0


if __name__ == "__main__":
    sys.exit(main())
