"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points default to the CUDA card and never fall back to the CPU, and
its kernel wrappers run their plain versions only for CPU tensors."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

MODULES = [
    "repro_torch", "repro_torch._device", "repro_torch.convert",
    "repro_torch.core", "repro_torch.core.prng", "repro_torch.core.rng",
    "repro_torch.core.latent", "repro_torch.core.rtbs", "repro_torch.core.api",
    "repro_torch.core.simple", "repro_torch.kernels.variates",
    "repro_torch.kernels.variates.ops", "repro_torch.kernels.variates.kernel",
    "repro_torch.kernels.variates.ref", "repro_torch.kernels.variates.cases",
    "repro_torch.kernels", "repro_torch.kernels._build",
    "repro_torch.kernels.tbs_step.ops", "repro_torch.kernels.tbs_step.kernel",
    "repro_torch.kernels.reservoir_compact.ops",
    "repro_torch.kernels.reservoir_compact.kernel",
    "repro_torch.kernels.reservoir_compact.ref", "repro_torch.kernels.reservoir_compact.bench",
    "repro_torch.kernels._common",
    "repro_torch.kernels.swap_delete.ops", "repro_torch.kernels.swap_delete.kernel",
    "repro_torch.kernels.swap_delete.ref", "repro_torch.kernels.swap_delete.bench",
    "repro_torch.decay", "repro_torch.decay.schedules", "repro_torch.decay.adaptive",
    "repro_torch.data.streams",
    "repro_torch.models.simple_ml", "repro_torch.manage",
    "repro_torch.manage.models", "repro_torch.manage.loop",
    "repro_torch.obs.profile", "repro_torch.bank", "repro_torch.bank.routing",
    "repro_torch.bank.bank", "repro_torch.manage.bank_loop",
    "repro_torch.kernels.tbs_step.ref", "repro_torch.kernels.tbs_step.bench",
    "repro_torch.kernels._bench",
    "repro_torch.kernels.flash_attention", "repro_torch.kernels.flash_attention.ops",
    "repro_torch.kernels.flash_attention.kernel", "repro_torch.kernels.flash_attention.ref",
    "repro_torch.config", "repro_torch.configs", "repro_torch.configs.stablelm_12b",
    "repro_torch.configs.granite_20b", "repro_torch.configs.command_r_35b",
    "repro_torch.configs.mistral_large_123b", "repro_torch.models.layers",
    "repro_torch.models.attention", "repro_torch.models.transformer",
    "repro_torch.models.zoo", "repro_torch.train", "repro_torch.train.steps",
    "repro_torch.launch", "repro_torch.launch.serve",
    "repro_torch.configs.mamba2_370m", "repro_torch.kernels.ssd_scan",
    "repro_torch.kernels.ssd_scan.ops", "repro_torch.kernels.ssd_scan.kernel",
    "repro_torch.kernels.ssd_scan.ref", "repro_torch.kernels.ssd_scan.ablate",
    "repro_torch.models.ssm",
    "repro_torch.models.mamba_lm",
    "repro_torch.optim", "repro_torch.optim.adamw", "repro_torch.optim.schedule",
    "repro_torch.checkpoint", "repro_torch.checkpoint.store",
    "repro_torch.obs", "repro_torch.obs.sinks", "repro_torch.obs.monitors",
    "repro_torch.obs.probe", "repro_torch.obs.telemetry",
    "repro_torch.launch.train",
    "repro_torch.core.distributed", "repro_torch.launch.mesh", "repro_torch.data",
    "repro_torch.data.pipeline",
    "repro_torch.configs.granite_moe_3b", "repro_torch.configs.mixtral_8x22b",
    "repro_torch.configs.qwen2_vl_2b", "repro_torch.configs.zamba2_2p7b",
    "repro_torch.configs.whisper_large_v3", "repro_torch.models.moe",
    "repro_torch.models.hybrid", "repro_torch.models.encdec",
]


def test_imports_without_jax_or_the_jax_package():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        f"import importlib\nfor m in {MODULES!r}:\n    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')"
        " or m.startswith('jax')]\n"
        "assert not [m for m in bad if sys.modules[m] is not None], bad\n"
        "print('isolated', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from repro " not in src
    assert "from repro." not in src and "import repro\n" not in src


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch import convert
    from repro_torch.core.api import make_sampler
    from repro_torch.data.streams import LinRegStream
    from repro_torch.decay import decay_profile, exponential
    from repro_torch.bank import make_bank
    from repro_torch.config import get_smoke_config
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.manage import make_model, materialize_stream
    from repro_torch.models import zoo

    api = zoo.build(get_smoke_config("stablelm_12b"))
    ssm = zoo.build(get_smoke_config("mamba2_370m"))
    zoo_rest = [zoo.build(get_smoke_config(a)) for a in
                ("granite_moe_3b", "qwen2_vl_2b", "zamba2_2p7b", "whisper_large_v3")]
    kv = {"k": [[[[[0.0]]]]], "v": [[[[[0.0]]]]], "length": [0]}
    for call in (lambda: make_sampler("rtbs", n=4, lam=0.1),
                 lambda: make_sampler("drtbs", n=4, lam=0.1, cap_s=8),
                 lambda: make_data_mesh(4),
                 lambda: make_bank("rtbs", num_keys=4, n=2, lam=0.1),
                 lambda: make_bank("ttbs", num_keys=4, n=2, lam=0.1, batch_size=1.0),
                 lambda: make_model("linreg"),
                 lambda: materialize_stream(LinRegStream(), 2, batch_size=3),
                 lambda: decay_profile(exponential(0.1), 3),
                 lambda: convert.params_from_numpy("linreg", [0.0, 0.0, 0.0]),
                 lambda: api.init_params(0),
                 lambda: api.init_decode_state(2, 8),
                 lambda: ssm.init_params(0),
                 lambda: ssm.init_decode_state(2, 8),
                 lambda: convert.ssm_caches_from_numpy(ssm.cfg, [[[[0.0]]]], [[[[[0.0]]]]]),
                 lambda: serve.main(["--gen", "1"]),
                 lambda: serve.main(["--arch", "stablelm_12b", "--gen", "1"]),
                 lambda: train.main(["--arch", "mamba2_370m", "--ticks", "1"]),
                 lambda: convert.kv_caches_from_numpy(api.cfg, **kv),
                 lambda: convert.encdec_caches_from_numpy(api.cfg, kv, ([0.0], [0.0])),
                 lambda: convert.hybrid_caches_from_numpy(
                     ssm.cfg, {"conv": [[[[[0.0]]]]], "state": [[[[[[0.0]]]]]]}, kv),
                 *(lambda m=m: m.init_params(0) for m in zoo_rest),
                 *(lambda m=m: m.init_decode_state(2, 8) for m in zoo_rest),
                 *(lambda a=a: serve.main(["--arch", a, "--gen", "1"]) for a in
                   ("granite_moe_3b", "mixtral_8x22b", "qwen2_vl_2b", "zamba2_2p7b",
                    "whisper_large_v3"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_wrappers_take_plain_versions_on_cpu_and_count_no_launch():
    from repro_torch import kernels
    from repro_torch.kernels.reservoir_compact.ops import reservoir_compact
    from repro_torch.kernels.swap_delete.ops import swap_delete
    from repro_torch.kernels.tbs_step.ops import tbs_step_apply

    from repro_torch.bank import route
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.tbs_step.ops import tbs_step_apply_banked

    kernels.reset_launches()
    tbs_step_apply(torch.arange(5.0), torch.ones(2), torch.tensor([5, 0, 1, 6, 2]))
    reservoir_compact(torch.arange(5.0), torch.tensor([1, 0, 1, 0, 1]).bool())
    swap_delete(6, torch.tensor(2), torch.tensor(5), torch.tensor([7, 3, 1]), 2)
    bank = torch.zeros(3, 4)
    r = route(torch.tensor([2, 0, 2]), 3, num_keys=3, bcap=2)
    tbs_step_apply_banked(bank, torch.tensor([1.0, 2.0, 3.0]),
                          torch.tensor([[4, 5, 0, 1]] * 3), order=r.order,
                          starts=r.starts, touched=r.touched, ntouched=r.ntouched,
                          bcap=2)
    # key 0's slot 1 reads past its one arrival, into key 2's segment
    assert bank.tolist() == [[2.0, 1.0, 0.0, 0.0], [0.0] * 4, [1.0, 3.0, 0.0, 0.0]]
    q = torch.randn(1, 4, 2, 8)
    assert flash_attention(q, q[:, :, :1], q[:, :, :1]).shape == q.shape
    x = torch.randn(1, 4, 2, 8)
    y, _ = ssd_scan(x, torch.rand(1, 4, 2), -torch.ones(2), x[:, :, :1], x[:, :, 1:],
                    chunk=2)
    assert y.shape == x.shape
    from repro_torch.kernels.variates.ops import binomial, hypergeometric

    assert binomial(torch.tensor([[1, 2]]), torch.tensor([5]), torch.tensor([1.0])).tolist() == [5]
    assert hypergeometric(torch.tensor([0.5]), torch.tensor([3]), torch.tensor([3]),
                          torch.tensor([0]), 4).tolist() == [3]
    assert kernels.launches() == {"tbs_step_apply": 0, "tbs_step_apply_banked": 0,
                                  "reservoir_compact": 0, "swap_delete": 0,
                                  "binomial": 0, "hypergeometric": 0,
                                  "flash_attention": 0, "ssd_scan": 0}
