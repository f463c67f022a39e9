"""The import check compares whole top-level names; the harness and the
reference load no JAX and no JAX package, and the reference and the kernel
files nothing of the program outside ``program()``."""

import subprocess
import sys

from benchmark import run


def test_top_level_names_are_compared_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "rgp_tpu", "rgp_tpu.models.rgp",
             "rgp_tpu_torch", "rgp_tpu_torch.models.rgp", "jaxtyping", "rgp_tpu_extra", "flaxen", "torch"]
    assert run.forbidden_modules(names) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "rgp_tpu",
                                            "rgp_tpu.models.rgp"]


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted(sys.modules)))"],
                         capture_output=True, text=True, check=True, cwd=run.ROOT, timeout=300)
    return out.stdout.split()


def test_the_harness_and_the_program_load_no_jax():
    mods = _loaded("import benchmark.run, benchmark.drive, benchmark.check, benchmark.faults, benchmark.rehearse\n"
                   "import rgp_tpu_torch.bench.serving, rgp_tpu_torch.models.rgp")
    assert "rgp_tpu_torch" in mods
    assert run.forbidden_modules(mods) == []


def test_the_reference_imports_nothing_of_the_program():
    mods = _loaded("import benchmark.reference, benchmark.inputs, benchmark.check, benchmark.yardstick")
    assert not [m for m in mods if m.split(".")[0] in ("rgp_tpu_torch", "rgp_tpu", "jax")]


def test_kernel_files_import_the_program_only_in_program():
    mods = _loaded("import torch\nfrom benchmark import reference as r, inputs\n"
                   "for f in sorted(r.KERNELS.glob('*.py')):\n"
                   "    kf = r.kernel_file(f.stem)\n"
                   "    p = kf.hyper(inputs.member(kf.init(1, 3, torch.float64, 'cpu'), 0))\n"
                   "    X = torch.ones(4, 3, dtype=torch.float64)\n"
                   "    kf.K(p, X, X), kf.psi0(p, X, X), kf.psi1(p, X, X, X), kf.psi2(p, X, X, X)\n"
                   "    kf.psi2_sum(p, X, X, X, 2), kf.work(4, 3), kf.time_sum_work(4, 4, 3)")
    assert "benchmark.reference" in mods
    assert not [m for m in mods if m.split(".")[0] in ("rgp_tpu_torch", "rgp_tpu", "jax")]
    mods = _loaded("from benchmark import reference as r\n"
                   "for f in sorted(r.KERNELS.glob('*.py')):\n    r.kernel_file(f.stem).program(3)")
    assert "rgp_tpu_torch.kernels" in mods and run.forbidden_modules(mods) == []
