#!/usr/bin/env python3
"""The SASS of the whole-tree updates (K8's and K9's libraries) and of
the decode kernels (K2-K5's libraries) of one source tree, function by
function, and whether two trees' is the same.

    python3 tools/torch_update_sass.py TREE > A.json   # nvcc, cuobjdump
    python3 tools/torch_update_sass.py A.json B.json   # compare two

With one argument it builds the kernels of the source tree TREE (its own
``kernels/_build.py``: its flags, into its ``build/kernels``, reusing a
library already there) and prints one JSON object: for each kernel
function of ``LIBS`` (demangled; K2-K5's fp32 ``float`` element-type
argument dropped, so a tree from before their 16-bit instances names its
fp32 functions alike) its instruction count; its conversions between fp32 and 16
bits (``cvt``: F2F, F2FP, HADD2.F32), MUFU, FCHK and packed 16-bit
arithmetic (``packed``: HADD2, HMUL2, HFMA2); the same counts inside its
vector loop (first vector load to last vector store) per element one
iteration takes; and a digest of its instruction text.  With two it
reads two such outputs and prints, function by function, whether their
SASS is the same (equal digests).  Time the kernels with
``chip_smoke.py --half`` run from each tree."""
import hashlib
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

LIBS = ("multi_tensor_adam", "multi_tensor_update", "paged_decode",
        "decode", "paged_verify", "verify")
# the 16-bit instances' template arguments in a demangled kernel name:
# K8's and K9's Half16 precision, K2-K5's element type
HALF16 = tuple(f"Prec<{e}, {e}, {e}, {e}, {e}, void>"
               for e in ("__nv_bfloat16", "__half")) \
    + tuple(f", {e}>" for e in ("__nv_bfloat16", "__half"))


def base_name(name):
    """A K2-K5 kernel ``name`` as its template and its arguments, without
    the parameter list and the fp32 element-type argument (the parent of
    the 16-bit instances had neither an element type nor ``T3`` in its
    parameters); any other name as it is."""
    m = re.match(r"(.*mxdec::(?:split|merge)_kernel<.*?)(, float)?>\(",
                 name)
    return name if m is None else m.group(1) + ">"


def sass_functions(lib):
    """{demangled kernel name: [instruction text, ...]} of ``lib``."""
    cuda = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin"
    sass = subprocess.run([str(cuda / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    filt = shutil.which("cu++filt", path=str(cuda)) or shutil.which(
        "c++filt")
    out, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            if filt:
                name = subprocess.run([filt, name], capture_output=True,
                                      text=True).stdout.strip() or name
            cur = out.setdefault(base_name(name), [])
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(.*?)\s*;", ln)
        if m and cur is not None:
            cur.append(m.group(1))
    return out


def classify(ins):
    """Counts of ``cvt``, ``mufu``, ``fchk`` and ``packed`` in ``ins``."""
    counts = {"cvt": 0, "mufu": 0, "fchk": 0, "packed": 0}
    for text in ins:
        op = text.split()[1] if text.startswith("@") else text.split()[0]
        base = op.split(".")[0]
        if base in ("F2F", "F2FP") or op.startswith("HADD2.F32"):
            counts["cvt"] += 1
        elif base in ("HADD2", "HMUL2", "HFMA2"):
            counts["packed"] += 1
        elif base in ("MUFU", "FCHK"):
            counts[base.lower()] += 1
    return counts


def per_element(name, ins):
    """The counts inside the vector loop per element it handles: 8 for a
    16-bit instance with 16-byte accesses, else 4 (a float4, or 8 bytes
    of 16-bit values).  None where the function has no vector loop."""
    loads = [i for i, t in enumerate(ins)
             if re.match(r"(@\S+ )?LDG\.E\.(128|64)", t)]
    stores = [i for i, t in enumerate(ins)
              if re.match(r"(@\S+ )?STG\.E\.(128|64)", t)]
    if not loads or not stores or stores[-1] < loads[0]:
        return None
    body = ins[loads[0]:stores[-1] + 1]
    wide = any(".128" in ins[i] for i in loads)
    elems = 8 if (wide and any(h in name for h in HALF16)) else 4
    return {"elements": elems, "instructions": len(body) / elems,
            **{k: v / elems for k, v in classify(body).items()}}


def digest(tree):
    """Build ``tree``'s update libraries and print their SASS record."""
    tree = Path(tree).resolve()
    sys.path.insert(0, str(tree))
    build = importlib.import_module(
        "incubator_mxnet_tpu_torch.kernels._build")
    if not build.__file__.startswith(str(tree)):
        raise SystemExit(f"imported {build.__file__}, not from {tree}")
    report = build.build_all()
    sass = {}
    for lib in LIBS:
        for name, ins in sass_functions(report[lib]["path"]).items():
            sass[f"{lib}: {name}"] = {
                "instructions": len(ins), **classify(ins),
                "loop_per_element": per_element(name, ins),
                "digest": hashlib.sha256(
                    "\n".join(ins).encode()).hexdigest()[:16]}
    print(json.dumps({"tree": str(tree), "sass": sass}))


def compare(a_path, b_path):
    """Print, for every kernel function of two outputs, whether its SASS
    is the same in both."""
    a, b = (json.loads(Path(p).read_text().strip().splitlines()[-1])
            for p in (a_path, b_path))
    a["sass"], b["sass"] = ({base_name(k): v for k, v in x["sass"].items()}
                            for x in (a, b))
    keys = sorted(set(a["sass"]) | set(b["sass"]))
    same = 0
    for key in keys:
        x, y = a["sass"].get(key), b["sass"].get(key)
        if x is None or y is None:
            state = "only in " + (b_path if x is None else a_path)
        elif x["digest"] == y["digest"]:
            state, same = "same", same + 1
        else:
            state = (f"differs ({x['instructions']} and "
                     f"{y['instructions']} instructions)")
        kind = "16-bit" if any(h in key for h in HALF16) else "other"
        print(f"{kind} {key}: {state}")
    print(f"{same} of {len(keys)} functions the same ({a['tree']} against "
          f"{b['tree']})")


if __name__ == "__main__":
    if len(sys.argv) == 2:
        digest(sys.argv[1])
    elif len(sys.argv) == 3:
        compare(*sys.argv[1:])
    else:
        raise SystemExit(__doc__)
