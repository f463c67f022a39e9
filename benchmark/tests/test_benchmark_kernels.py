"""A configuration names its kernels as files (``benchmark/kernels/<name>.py``),
so that a new kernel enters the benchmark as new files only; the kernel
files of today's configurations give the program the configuration it ran
before they existed, and the yardstick the same counts."""

import hashlib
import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from benchmark import drive, run, yardstick
from benchmark import reference as ref

CELLS = ["rgp1-rollout-w16384", "rgp2mlp-rollout-w1024"]

# A kernel the benchmark does not have: k(x, x') = sum_q v_q x_q x'_q, with
# its expectations under x ~ N(mu, diag s) written out here.
LINEAR_ARD = '''
"""Linear kernel with a variance for each input dimension."""

import torch

from ..reference import mm, softplus, softplus_inv


def program(din):
    from rgp_tpu_torch.kernels import Linear

    return Linear(input_dim=din)


def init(n, din, dtype, device):
    return {"log_var": torch.full((n, din), softplus_inv(1.0), dtype=dtype, device=device)}


def hyper(kp):
    return {"v": softplus(kp["log_var"])}


def K(p, X, X2):
    return mm(X * p["v"], X2.mT)


def psi0(p, mu, s):
    return (p["v"] * (mu * mu + s)).sum(-1)


def psi1(p, Z, mu, s):
    return mm(mu * p["v"], Z.mT)


def psi2(p, Z, mu, s):
    """psi1_m psi1_n + sum_q v_q^2 s_q z_mq z_nq, a step at a time."""
    a = psi1(p, Z, mu, s)
    Zv = Z * p["v"]
    return a[:, :, None] * a[:, None, :] + mm(Zv[None] * s[:, None, :], Zv.mT)


def psi2_sum(p, Z, mu, s, block):
    a = psi1(p, Z, mu, s)
    Zv = Z * p["v"]
    return mm(a.mT, a) + mm(Zv * s.sum(0), Zv.mT)


def work(M, Q):
    return {"psi0": 4 * Q, "psi1": 2 * M * Q + Q, "psi2": M * (M + 1) // 2 * (2 * Q + 2)}


def time_sum_work(T, M, Q):
    return 2 * T * M * M + 2 * M * M * Q, 0, 4 * (2 * T * Q + M * Q + M * M)
'''

# Drives the copy's harness in its own process, so that ``benchmark`` is the
# copy and every file the run finds is the copy's.
DRIVE = '''
import json, torch
from benchmark import drive, inputs, run, yardstick
from benchmark import reference as ref
from rgp_tpu_torch.bench import serving
from rgp_tpu_torch.models import rgp

cpu = torch.device("cpu")
cell = run.load_cell("rgp1lin-rollout-w16")
cfg = dict(cell.config, jitter=1e-12)  # the program's float64 jitter base
rec = inputs.record(cfg, torch.float64, cpu, T=cfg["T"])
params = inputs.member(inputs.init_params(cfg, rec, 1, inputs.generator(3, cpu), torch.float64), 0)
pc = drive.program_cfg(cfg)
Us = inputs.candidates(cfg, rec, cell.traffic["width"], cell.traffic["horizon"], inputs.generator(5, cpu))
m, v = serving.batched_freerun(pc, params, rec.Y, rec.U, Us)
lad = ref.Ladder({"c": [0.2, 4.0]})
roll = [max(float((m - mr).abs().max()), float(((v - vr) / vr).abs().max()))
        for _, mr, vr in ref.rollout_branches(cfg, params, rec.Y, rec.U, Us, lad)]

wh = rgp.compute_whitenings(pc, params, rec.Y, rec.U, block=None)
names = [k for k, _ in ref.tree_leaves(params)]
leaves = [x.clone().requires_grad_(True) for _, x in ref.tree_leaves(params)]
loss = -rgp.elbo(pc, ref.tree_with(params, leaves), rec.Y, rec.U, block=None, whitening=wh)
g_prog = torch.autograd.grad(loss, leaves)
best = None
for bases in __import__("itertools").product(*ref.refresh(cfg, params, rec.Y, rec.U, lad)):
    rl = [x.clone().requires_grad_(True) for _, x in ref.tree_leaves(params)]
    for _, rloss in ref.neg_elbo(cfg, ref.tree_with(params, rl), rec.Y, rec.U, list(bases), ladder=lad):
        gap = abs(float(rloss) - float(loss)) / abs(float(loss))
        if best is None or gap < best[0]:
            best = (gap, torch.autograd.grad(rloss, rl, retain_graph=True))
grad = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max())) for a, b in zip(g_prog, best[1]))
print(json.dumps({"kernels": [type(l.kernel).__name__ for l in pc.layers] + [type(pc.out_kernel).__name__],
                  "kern_leaves": {k: list(x.shape) for k, x in zip(names, leaves) if "/kern/" in k},
                  "rollout_gap": min(roll), "bound_gap": best[0], "grad_gap": grad,
                  "per_step": yardstick.rollout_per_step(cfg, cell.traffic, rec.Y.shape[0])}))
'''


def _copy_checkout(root):
    """BENCHMARK.json and the harness, as a checkout holds them, beside the
    program (linked, not copied)."""
    shutil.copytree(run.HERE, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(run.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "rgp_tpu_torch").symlink_to(run.ROOT / "rgp_tpu_torch", target_is_directory=True)


def _digests(here):
    return {p.relative_to(here): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(here.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _add_cell(root, config, kernel_files):
    """A configuration, its kernel files, a traffic mix, a limits file and
    the BENCHMARK.json entries of one new cell, ``rgp1lin-rollout-w16``."""
    here = root / "benchmark"
    for name, text in kernel_files.items():
        (here / "kernels" / f"{name}.py").write_text(textwrap.dedent(text))
    (here / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
    traffic = dict(json.loads((here / "traffic" / "rollout-w1024.json").read_text()), width=16, horizon=4)
    (here / "traffic" / "rollout-w16.json").write_text(json.dumps(traffic))
    limits = (here / "limits" / "rgp1-rollout-w16384.json").read_text()
    (here / "limits" / "rgp1lin-rollout-w16.json").write_text(limits)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": config["name"], "source": "https://arxiv.org/abs/1511.06644",
                            "file": f"benchmark/configs/{config['name']}.json", "reduced": [],
                            "why": "config 1 with a linear hidden kernel"})
    spec["workloads"].append({"name": "rgp1lin-rollout-w16", "config": config["name"], "traffic": "rollout-w16",
                              "chips": 1, "why": "a narrow rollout"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("rgp1lin-rollout-w16")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def _small_config(**kw):
    cfg = json.loads((run.HERE / "configs" / "rgp1-actuator-M100.json").read_text())
    cfg.pop("served_params")
    return dict(cfg, name="rgp1lin-actuator-M12", T=64, num_inducing=12, **kw)


def test_a_new_kernel_is_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    _copy_checkout(root)
    before = _digests(root / "benchmark")
    _add_cell(root, _small_config(kernel="linear_ard", out_kernel="rbf_ard"), {"linear_ard": LINEAR_ARD})
    after = _digests(root / "benchmark")
    assert {k: after[k] for k in before} == before  # no file of the harness was edited, BENCHMARK.json aside

    out = subprocess.run([sys.executable, "-c", DRIVE], cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["kernels"] == ["Linear", "RBF"]
    assert got["kern_leaves"] == {"layers/0/kern/log_var": [20], "out/kern/log_ls": [1], "out/kern/log_var": []}
    assert got["rollout_gap"] < 1e-8
    assert got["bound_gap"] < 1e-10 and got["grad_gap"] < 1e-7
    assert got["per_step"] > 0


def test_an_unknown_kernel_fails_at_load_and_lists_the_files(tmp_path):
    root = tmp_path / "checkout"
    _copy_checkout(root)
    _add_cell(root, _small_config(kernel="rbf_ard", out_kernel="no_such_kernel"), {})
    with pytest.raises(ValueError, match=r"unknown kernel 'no_such_kernel'.*\['rbf_ard'\]"):
        run.load_cell("rgp1lin-rollout-w16", root=root)


@pytest.mark.parametrize("name", CELLS)
def test_program_cfg_is_the_one_before_kernel_files(name):
    """What ``drive.program_cfg`` gave when every layer was RBF by default."""
    from rgp_tpu_torch.models import rgp

    cfg = run.load_cell(name).config
    assert drive.program_cfg(cfg) == rgp.deep_rgp_config(
        wins=list(cfg["wins"]), u_win=cfg["u_win"], y_dim=1, u_dim=1, num_inducing=cfg["num_inducing"],
        back_cstr=bool(cfg.get("back_cstr")), mlp_hidden=tuple(cfg.get("mlp_hidden", ())),
        noise_floor=cfg["noise_floor"])


@pytest.mark.parametrize("name,T,want", [
    ("rgp1-rollout-w16384", 512, 6114037266.666666),
    ("rgp2mlp-rollout-w1024", 250, 556497493.75),
])
def test_rollout_per_step_at_full_size(name, T, want):
    """The operations ``mfu.rollout`` divides by, pinned as the yardstick
    counted them before the counts moved into kernel files."""
    cell = run.load_cell(name)
    assert yardstick.rollout_per_step(cell.config, cell.traffic, T) == want


def test_out_kernel_defaults_to_kernel():
    cfg = run.load_cell("rgp1-rollout-w16384").config
    assert "out_kernel" not in cfg
    assert ref.layer_kernels(cfg) == [ref.kernel_file("rbf_ard")] * 2
