"""K2's time at the probes' shape with one part of its kernel switched off at
a time: the probes' split (``chip_smoke.py`` ``probe_split``) checked by
ablation, for K2's second pass.

    python -m ml_mdm_tpu_torch.tools.ablate_k2

Builds copies of ``csrc/conv3x3_wgmma.cuh`` (K2's kernel, which the probes
instantiate too) with a part switched off by text replacement, behind a
guard that is false at run time, into ``ml_mdm_tpu_torch/_build/ablate/``
(one nvcc a library, in parallel). Each copy's probe library gets two more
instances: K2 itself through the probes' entry (9 taps at K2's offsets, the
halo and K2's zero fill) and the same with ``PROBE_SERIAL`` (the next
chunk's activation after the products, not under them). With each copy's
libraries it times (median of 5 from CUDA events, the L2 overwritten
before each run, ``bench_k2_k3._ms``) K2, K2 as a probe, K2 serial and the
probe rows of ``ROWS`` at B = 4, 512^2, 128 -> 128, bf16:

  base          the kernel as it is
  no epilogue   the epilogue's stores of y skipped
  no products   the wgmma products skipped (the k-step loop with its
                ldmatrix, fences and waits, the weight ring and the staging
                kept)

K2 as a probe and K2 serial are held bitwise equal to K2 (base), the probe
rows within 2e-2 of their plain versions. Without a card it exits 1.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

B, H, W, C = 4, 512, 512, 128
STORE = "*reinterpret_cast<__nv_bfloat162*>(out + o) = st;"
ISSUE = "issue(acc, af[b], (s + tap) % p.stages, ks);"
VARIANTS = {
    "base": (),
    "no epilogue": ((STORE, "if (p.B < 0) " + STORE),),
    "no products": ((ISSUE, "if (p.B < 0) " + ISSUE),),
}
# K2 through the probes' entry, overlapped and serial
K2_INSTANCES = ("    INSTANCE(taps(9), false),\n"
                "    INSTANCE(taps(9) | PROBE_SERIAL, false),\n")
ANCHOR = "    INSTANCE(p2(1, 1, 1), true),   // ALL (the real kernel's shape)\n"
ROWS = ("dots direct from input block", "dots direct, 1 tap", "copy->scratch + 9 dots",
        "act+silu->scratch + 9 dots", "pure copy through scratch",
        "base: 4 dots, single buf", "+dbuf", "ALL (the real kernel's shape)")


def build(root):
    """The variants' sources and libraries under ``root``; returns
    {variant: directory}."""
    from ml_mdm_tpu_torch.ops import cuda_build

    csrc = cuda_build.source_path("fused_resnet").parent
    dirs, procs = {}, []
    for i, (name, edits) in enumerate(VARIANTS.items()):
        d = dirs[name] = root / f"v{i}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        text = (d / "conv3x3_wgmma.cuh").read_text()
        for old, new in edits:
            assert text.count(old) == 1, old
            text = text.replace(old, new)
        (d / "conv3x3_wgmma.cuh").write_text(text)
        probes = (d / "kernel_anatomy.cu").read_text()
        assert probes.count(ANCHOR) == 1
        (d / "kernel_anatomy.cu").write_text(probes.replace(ANCHOR, ANCHOR + K2_INSTANCES))
        for lib in ("fused_resnet", "kernel_anatomy"):
            procs.append(subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(d / f"{lib}.so"),
                 str(d / f"{lib}.cu")], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
    for p in procs:
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed:\n{err.decode()[-4000:]}")
    return dirs


def main() -> int:
    import torch

    from ml_mdm_tpu_torch.ops import cuda_build
    from ml_mdm_tpu_torch.ops import fused_resnet as fr
    from ml_mdm_tpu_torch.ops import kernel_anatomy as ka
    from ml_mdm_tpu_torch.tools.bench_k2_k3 import _ms

    if not torch.cuda.is_available():
        print("ablate_k2: no CUDA device; the kernels run only on a GPU", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dirs = build(cuda_build.BUILD_DIR / "ablate")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = (torch.randn((B, H, W, C), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    w3 = (torch.randn((3, 3, C, C), generator=g, device=dev) / (9 * C) ** 0.5).to(torch.bfloat16)
    a, b = torch.full((B, C), ka.SCALE, device=dev), torch.full((B, C), ka.OFFSET, device=dev)
    plan = fr.conv_plan(B, H, W, (C,), C)
    assert (plan.bn, plan.mt) == (ka.BN, ka.MT)
    wt = fr.conv_weight_layout((w3,))
    sw = plan.tw + 2
    toff = (ctypes.c_int * 16)(*[(t // 3) * sw + t % 3 for t in range(9)], *[0] * 7)
    probes = [(label, v) for (label, _), v in zip(ka.P1_ROWS + ka.P2_ROWS, ka.VARIANTS)
              if label in ROWS]
    weights = {v: (torch.randn((max(v.n_taps, 1), C, C), generator=g, device=dev) * 0.05)
               .to(torch.bfloat16) for _, v in probes}
    load_fr, load_ka = fr.load_library.__wrapped__, ka.load_library.__wrapped__
    ref = None
    for name, d in dirs.items():
        fr.build_library = lambda d=d: d / "fused_resnet.so"
        ka.build_library = lambda d=d: d / "kernel_anatomy.so"
        flib, klib = load_fr(), load_ka()
        fr.load_library, ka.load_library = (lambda f=flib: f), (lambda k=klib: k)

        def k2_probe(flags, klib=klib):
            y = torch.empty_like(x)
            err = klib.ml_mdm_kernel_anatomy(
                flags, 0, ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(a.data_ptr()),
                ctypes.c_void_p(b.data_ptr()), ctypes.c_void_p(wt.data_ptr()),
                ctypes.c_void_p(y.data_ptr()), B, H, W, C, 1, plan.th, plan.tw, plan.stages,
                plan.grid, toff, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if err:
                raise RuntimeError(f"ablate_k2: CUDA error {err}")
            return y

        k2_flags = ka.ON | 9 << 8
        rows = {"K2": lambda: fr.affine_silu_conv3x3(x, a, b, w3, None),
                "K2 as a probe": lambda: k2_probe(k2_flags),
                "K2 serial": lambda: k2_probe(k2_flags | ka.SERIAL)}
        if ref is None:
            ref = rows["K2"]()
            for label in ("K2 as a probe", "K2 serial"):
                if not torch.equal(rows[label](), ref):
                    raise AssertionError(f"ablate_k2: {label} is not bitwise K2")
            for label, v in probes:
                out = ka.anatomy(x, weights[v], v).float()
                plain = ka.anatomy_plain(x, weights[v], v).float()
                if not float((out - plain).abs().max()) <= 2e-2 * float(plain.abs().max()):
                    raise AssertionError(f"ablate_k2: probe {label} disagrees with plain")
        for label, v in probes:
            rows[label] = lambda v=v: ka.anatomy(x, weights[v], v)
        for label, fn in rows.items():
            print(f"ablate {name}: {label}: {_ms(fn):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
