"""The port's error-feedback gradient compression
(``repro_torch.optim.compress``) and ``expected_shortfall`` against the JAX
package's, and the four ``examples_torch/`` scripts on the CPU:

  * ``ef_init``, ``compress_grads`` and ``decompress_grads`` equal JAX's bit
    for bit on a tree of f32 and bf16 leaves, an all-zero leaf and values
    on exact .5 steps (round half to even), over two steps of error
    feedback;
  * ``expected_shortfall`` equals JAX's;
  * each example's ``main`` runs with ``--device cpu`` at reduced sizes,
    raises without a card when no device is given (no fallback to the
    CPU), and imports neither JAX nor the JAX package.
"""
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.simple_ml import expected_shortfall as j_expected_shortfall
from repro.optim import compress as jc
from repro_torch.models.simple_ml import expected_shortfall
from repro_torch.optim import compress_grads, decompress_grads, ef_init

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "lm_online_management", "serve_batched", "distributed_reservoir")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree():
    rs = np.random.default_rng(0)
    return {
        "w": (rs.standard_normal((5, 7)) * 3.0).astype(np.float32),
        "b": (rs.standard_normal((3, 4)) * 1e-3).astype(jnp.bfloat16),
        "zero": np.zeros((4,), np.float32),
        # scale 127 / 127 = 1: every other value sits on a .5 step
        "half": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -3.5], np.float32),
        "layers": [{"k": rs.standard_normal((2, 3)).astype(np.float32)}],
    }


def _to_torch(tree):
    return torch.utils._pytree.tree_map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
        if np.asarray(a).dtype == jnp.bfloat16 else torch.from_numpy(np.asarray(a)), tree)


def test_compress_equals_jax_over_two_steps_of_error_feedback():
    """Exact: q (int8), the scales and the f32 residuals, and the
    decompressed tree in f32 and bf16, for two steps fed their own ef."""
    g_np = _tree()
    g_j = {k: (jnp.asarray(v) if k != "layers" else [{"k": jnp.asarray(v[0]["k"])}])
           for k, v in g_np.items()}
    g_t = _to_torch(g_np)
    ef_j, ef_t = jc.ef_init(g_j), ef_init(g_t)
    for f in ("w", "b", "zero", "half"):
        assert ef_t[f].dtype == torch.float32 and not ef_t[f].any()
    for step in range(2):
        (q_j, s_j), ef_j = jc.compress_grads(g_j, ef_j)
        (q_t, s_t), ef_t = compress_grads(g_t, ef_t)
        for f in ("w", "b", "zero", "half"):
            np.testing.assert_array_equal(q_t[f].numpy(), np.asarray(q_j[f]))
            assert q_t[f].dtype == torch.int8
            np.testing.assert_array_equal(s_t[f].numpy(), np.asarray(s_j[f]))
            np.testing.assert_array_equal(ef_t[f].numpy(), np.asarray(ef_j[f]))
        np.testing.assert_array_equal(q_t["layers"][0]["k"].numpy(),
                                      np.asarray(q_j["layers"][0]["k"]))
        np.testing.assert_array_equal(ef_t["layers"][0]["k"].numpy(),
                                      np.asarray(ef_j["layers"][0]["k"]))
        for dt_t, dt_j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            d_t = decompress_grads(q_t, s_t, dt_t)
            d_j = jc.decompress_grads(q_j, s_j, dt_j)
            for f in ("w", "b", "zero", "half"):
                assert d_t[f].dtype == dt_t
                np.testing.assert_array_equal(d_t[f].float().numpy(),
                                              np.asarray(d_j[f], np.float32))
    # round half to even on the .5 steps, and the all-zero leaf stays zero
    assert q_t["zero"].tolist() == [0] * 4
    (q1, _), _ = compress_grads({"h": torch.from_numpy(g_np["half"])},
                                ef_init({"h": torch.from_numpy(g_np["half"])}))
    assert q1["h"].tolist() == [127, 0, 2, 2, 0, -2, 126, -4]
    with pytest.raises(ValueError, match="differ"):
        compress_grads({"a": torch.ones(2)}, {"b": torch.zeros(2)})


@pytest.mark.parametrize("frac", [0.1, 0.05, 0.5, 0.0, 1.0])
def test_expected_shortfall_equals_jax(frac):
    rs = np.random.default_rng(1)
    for v in (rs.standard_normal(37), rs.exponential(size=200).astype(np.float32), [3.0]):
        want = j_expected_shortfall(v, frac)
        assert expected_shortfall(v, frac) == want
        assert expected_shortfall(torch.as_tensor(np.asarray(v)), frac) == want


def _example(name):
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,argv", [
    ("quickstart", ["--trials", "20"]),
    ("lm_online_management", ["--ticks", "3"]),
    ("serve_batched", ["--gen", "3"]),
    ("distributed_reservoir", ["--ticks", "3"]),
])
def test_example_runs_on_the_cpu(name, argv):
    out = _example(name).main(argv + ["--device", "cpu"])
    if name == "quickstart":
        assert out["sizes"] == {"rtbs": 50, "brs": 50, "sw": 50, "ttbs": out["sizes"]["ttbs"]}
        assert len(out["probs"]) == 6 and len(out["runs"]) == 4
        assert all(np.isfinite(m[1:]).all() for _, _, m in out["runs"])
    elif name == "lm_online_management":
        assert len(out) == 3 and all(np.isfinite(r["eval_loss"]) for r in out)
    elif name == "serve_batched":
        assert out is not None
    else:
        state, _, trace = out
        assert trace["size"].shape == (3,) and int(state.overflow.sum()) == 0


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_the_card_without_fallback(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example(name).main([])


def test_examples_import_no_jax():
    code = (
        "import sys, importlib.util\n"
        "sys.modules['jax'] = None\nsys.modules['jaxlib'] = None\n"
        f"for n in {EXAMPLES!r}:\n"
        f"    spec = importlib.util.spec_from_file_location(n, {str(ROOT / 'examples_torch')!r}"
        " + '/' + n + '.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if (m == 'repro' or m.startswith('repro.')"
        " or m.startswith('jax')) and sys.modules[m] is not None]\n"
        "assert not bad, bad\nprint('isolated')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout
