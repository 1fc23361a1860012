#!/usr/bin/env python3
"""Compare the SASS of this tree's CUDA kernels with another tree's.

    python3 scripts/sass_diff.py --against build/ab_old \
        [--sources flash_attention,flash_attention_bwd]

Compiles each source of ``src/repro_torch/csrc`` named by ``--sources``
in both trees to a cubin for ``sm_90a`` (the port's nvcc flags, one
``nvcc`` a file, all started together), disassembles both with
``cuobjdump -sass`` and, for every kernel of the other tree, finds this
tree's kernel of the same name: the same template arguments, or the
same followed by a last ``false`` argument (an instance this tree added
a flag to, such as B9's ``kExt``: the instance without the flag is the
one that must still compile to the other tree's code).  Prints, a
kernel a line, whether the instruction streams are identical or how
many instructions differ, then a count per source.  Needs the CUDA
toolkit (``nvcc``, ``cuobjdump``, ``cu++filt``): run it on the card's
machine.  The other tree is unpacked as ``scripts/kernel_ab.py`` takes
it (``git archive <commit> src/repro_torch/csrc``).
"""
from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def compile_cubins(trees: dict, sources: list, out: Path) -> dict:
    """{(tree, source): cubin path}, all ``nvcc`` runs in parallel."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for tree, csrc in trees.items():
        for name in sources:
            cubin = out / f"{tree}_{name}.cubin"
            jobs[tree, name] = (cubin, subprocess.Popen(
                [build._nvcc(), *flags, "-cubin", str(csrc / f"{name}.cu"),
                 "-o", str(cubin)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    for (tree, name), (_, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {tree}'s {name}:\n{log}")
    return {key: cubin for key, (cubin, _) in jobs.items()}


def kernel_name(demangled: str) -> str:
    """``void (anonymous namespace)::k<(int)128, (bool)0>(...)`` ->
    ``k<128, 0>``: the name with its template arguments."""
    d = re.sub(r"\((?:int|bool)\)", "", demangled)
    d = re.sub(r"^void ", "", d.replace("<unnamed>::", "")
               .replace("(anonymous namespace)::", ""))
    depth = 0
    for i, ch in enumerate(d):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            return d[:i]
    return d


def kernels(cubin: Path) -> dict:
    """{kernel name: [instruction, ...]} of a cubin's SASS (addresses
    dropped)."""
    text = subprocess.run(["cuobjdump", "-sass", str(cubin)],
                          capture_output=True, text=True,
                          check=True).stdout
    code, cur = {}, None
    for line in text.splitlines():
        hit = re.search(r"Function : (\S+)", line)
        if hit:
            cur = hit.group(1)
            code[cur] = []
        elif cur and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            code[cur].append(re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)
                             .split(";")[0].strip())
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    names = list(code)
    demangled = subprocess.run([filt], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.split("\n")
    return {kernel_name(d): code[n] for n, d in zip(names, demangled)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, required=True,
                    help="a tree holding src/repro_torch/csrc")
    ap.add_argument("--sources", default="flash_attention,"
                    "flash_attention_bwd",
                    help="csrc sources (without .cu), comma-separated")
    args = ap.parse_args(argv)
    sources = [s.strip() for s in args.sources.split(",") if s.strip()]
    trees = {"this": ROOT / "src" / "repro_torch" / "csrc",
             "other": args.against / "src" / "repro_torch" / "csrc"}
    cubins = compile_cubins(trees, sources, ROOT / "build" / "sass_diff")
    for name in sources:
        this = kernels(cubins["this", name])
        other = kernels(cubins["other", name])
        same = differ = 0
        for key in sorted(other):
            # this tree's instance without its added flag, else the same
            mine = next((k for k in (key[:-1] + ", 0>", key + "<0>", key)
                         if k in this), None)
            if mine is None:
                print(f"{key}: not in this tree")
                continue
            a, b = this[mine], other[key]
            if a == b:
                same += 1
                print(f"{mine}: identical to the other's {key} "
                      f"({len(a)} instructions)")
                continue
            differ += 1
            at = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
            print(f"{mine}: {len(a)} instructions against the other's "
                  f"{key} {len(b)}, {len(at)} differ in place, the first "
                  f"at {at[0] if at else min(len(a), len(b))}")
        print(f"{name}: {same} of {same + differ} of the other tree's "
              f"kernels identical here; {len(this) - same - differ} "
              f"kernels only here")
    return 0


if __name__ == "__main__":
    sys.exit(main())
