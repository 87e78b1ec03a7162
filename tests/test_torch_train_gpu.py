"""The port's Shopformer trainer on the card.

Marked ``gpu``; without a card every test skips. Run on a machine with a
CUDA card (``--noconftest``: tests/conftest.py sets up JAX, which such a
machine need not have):

    python -m pytest --noconftest -m gpu tests/test_torch_train_gpu.py -q
"""

import copy

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    # decided here, not at import: every xdist worker must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _config(ckpt_dir, **training):
    from cvsd_tpu_torch.config import get_default_config

    cfg = get_default_config()
    cfg["data"]["dataset"] = "synthetic"
    cfg["data"]["synthetic"].update(num_train=64, num_test=64)
    cfg["data"]["batch_size"] = 16
    cfg["model"]["hidden_channels"] = 16
    cfg["training"].update(stage1_epochs=1, stage2_epochs=1, lr=1e-3, **training)
    cfg["experiment"]["checkpoint_dir"] = str(ckpt_dir)
    return cfg


def test_same_seed_twice_identical_on_the_card(cuda, tmp_path):
    """Augmentation and dropout on: two fits of one seed on the card end
    with the same weights bit for bit (the step generators live on the card
    and are seeded from host counters)."""
    from cvsd_tpu_torch.train.loop import Trainer

    states = []
    for i in range(2):
        tr = Trainer(_config(tmp_path / str(i)), verbose=False, device=cuda).setup()
        tr.fit()
        states.append({k: v.cpu() for k, v in tr.model.state_dict().items()})
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


@pytest.mark.parametrize("stage", [1, 2])
def test_train_step_card_matches_cpu(cuda, tmp_path, stage):
    """One float32 step's loss and gradients at the paper's width
    (augmentation off, dropout 0) from the same weights, card vs CPU, with
    chip_smoke.py's limits: the loss within 2e-6 relative; stage 1's
    gradients within 3e-2 of the largest gradient anywhere (flax's
    E[x^2] - E[x]^2 variance leaves them ill-conditioned in float32), stage
    2's within 3e-4 of each tensor's largest (a tensor that is rounding noise
    on the CPU, such as attention's key biases, against the largest
    anywhere)."""
    from cvsd_tpu_torch.train.loop import Trainer
    from cvsd_tpu_torch.utils.weights import load_flax_variables, state_dict_to_flax

    cfg = _config(tmp_path, grad_accum_steps=1)
    cfg["model"]["hidden_channels"] = 64
    cfg["data"]["batch_size"] = 32
    cfg["data"]["augment"]["enabled"] = False
    cfg["model"]["dropout"] = 0.0
    init = None
    out = {}
    for d in (cuda, torch.device("cpu")):
        tr = Trainer(cfg, verbose=False, device=d).setup()
        if init is None:
            init = state_dict_to_flax(tr.model)
        load_flax_variables(tr.model, init)
        probe = copy.deepcopy(tr.model)
        batch = next(tr.datamodule.train_batches(epoch=1))
        poses = torch.from_numpy(batch["poses"]).to(d)
        mask = torch.from_numpy(batch["mask"]).to(d)
        fn = probe.compute_gcae_loss if stage == 1 else probe.compute_transformer_loss
        loss = fn(poses, train=True, mask=mask)
        loss.backward()
        out[d.type] = (loss.item(), {n: p.grad.cpu().double() for n, p in probe.named_parameters()
                                     if p.grad is not None})
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    assert np.isfinite(lg) and abs(lg - lc) <= 2e-6 * abs(lc)
    gmax = max(float(g.abs().max()) for g in gc.values())
    for k, g in gc.items():
        gap = float((gg[k] - g).abs().max())
        if stage == 1:
            assert gap <= 3e-2 * gmax, k
        else:
            top = float(g.abs().max())
            assert gap <= 3e-4 * (top if top >= 1e-6 * gmax else gmax), k
