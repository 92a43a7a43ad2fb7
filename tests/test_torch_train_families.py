"""The port's training of the ssm, hybrid and encdec families against the
JAX package's, on the CPU (``lm_parity.check_train_step``: loss, every
gradient leaf, two steps of ``make_train_step``, one with ``micro_steps =
2``, then params and ``AdamWState``; f32 at 1e-5, bf16 within
``lm_parity.BF16_TRAIN``), and the per-layer recompute of each family's
training forward."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lm_parity  # noqa: E402
from lm_parity import one_thread  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs import registry as R  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import mamba2 as MB  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

ARCHS = ["mamba2-370m", "zamba2-2.7b", "whisper-tiny"]
CASES = [(a, dt) for a in ARCHS for dt in ("float32", "bfloat16")]


pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    return lm_parity.reference()


@pytest.mark.parametrize("arch,dtype", CASES,
                         ids=[f"{dt}-{a}" for a, dt in CASES])
def test_train_step_matches_reference(jx, arch, dtype):
    read = lm_parity.check_train_step(jx, arch, dtype,
                                      **lm_parity.train_tols(arch, dtype))
    print(f"{arch} {dtype} {read}")


# the function each family's training forward recomputes a layer with
LAYER_FNS = {"mamba2-370m": [(MB, "_train_mixer")],
             "zamba2-2.7b": [(MB, "_train_mixer"), (TF, "_train_block")],
             "whisper-tiny": [(ED, "_train_layer")],
             "qwen3-8b": [(TF, "_train_block")]}


@pytest.mark.parametrize("arch", sorted(LAYER_FNS))
def test_training_forward_recomputes_each_layer(jx, monkeypatch, arch):
    """With ``remat`` (the default) each layer runs twice in a step (the
    forward, then its recompute in the backward); without it once, with
    equal gradients; ``return_hidden`` gives the normed hidden whose
    unembed is the logits."""
    cfg = R.smoke_config(arch).replace(dtype="float32")
    _, tree = lm_parity.reference_params(jx, arch)
    batch = {k: torch.from_numpy(v) for k, v in
             lm_parity.train_batch(cfg, 3).items()}
    calls = []
    for mod, name in LAYER_FNS[arch]:
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name: (
            calls.append(_n), _r(*a))[1])
    n_fwd = (cfg.n_layers + cfg.n_layers // cfg.attn_every
             if cfg.family == "hybrid" else cfg.n_layers)
    grads = []
    for remat in (True, False):
        calls.clear()
        p, _ = convert.train_state_from_numpy(tree, device="cpu")
        for leaf in T.leaves(p):
            leaf.requires_grad_(True)
        hidden, _ = M.forward(cfg, p, batch, remat=remat, return_hidden=True)
        assert len(calls) == n_fwd
        hidden.square().mean().backward()
        assert len(calls) == n_fwd * (2 if remat else 1)
        grads.append([leaf.grad for leaf in T.leaves(p)])
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-7)
    with torch.no_grad():
        p, _ = convert.train_state_from_numpy(tree, device="cpu")
        logits, _ = M.forward(cfg, p, batch)
        hidden, _ = M.forward(cfg, p, batch, return_hidden=True)
        np.testing.assert_allclose(
            logits.numpy(), (hidden @ p["unembed"]).numpy(), rtol=1e-6,
            atol=1e-6)
