"""ventjax_torch's segmentation model (models/segmentation.py) and its
phantom generators against ventjax's, on the CPU.

The same inputs go through ventjax (JAX on the CPU; the U-Net has no
Pallas kernel) and the port.  Tolerances, each measured on these inputs:
- the phantom generators (make_random_phantom with a fixed shape and with
  shape=None, make_random_cohort, make_oof_phantom): bit-equal;
- params_from_flax / params_to_flax: an exact round trip;
- SegUNet logits at base 4 on seeded numpy parameters: max |d| <= 1e-5 of
  max |logit| (float32 convolutions in another order; ~1e-7 measured);
- the shipped checkpoint on 128x128x16 held-out phantoms: |d logit| <=
  1e-4 (4.6e-5 measured) and the masks equal;
- the committed seg_ckpt.npz: equal, array by array, to the orbax one;
- mask_qc: the reports equal;
- loss: relative 1e-5; gradients: 1e-4 of max |g| (~1e-6 measured);
- three Adam steps from the same parameters: each loss relative 1e-5 and
  the parameters within 1e-5 absolute, a hundredth of the learning rate
  (~1e-7 measured; Adam's first steps are ~lr sign(g), so a gradient near
  eps could move a parameter by up to lr).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from ventjax.io import phantom as jph
from ventjax.io.phantom_oof import make_oof_phantom as jax_oof
from ventjax.models import segmentation as jseg
from ventjax_torch.io import phantom as tph
from ventjax_torch.io.phantom_oof import make_oof_phantom as torch_oof
from ventjax_torch.models import segmentation as tseg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORBAX = os.path.join(REPO, "ventjax", "models", "seg_ckpt")
PHANTOM_KEYS = ("hp", "mask", "proton", "true_bias", "true_defect")
STEP_ATOL = 1e-5


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _dice(pred, true):
    return 2 * float((pred * true).sum()) / max(float(pred.sum()
                                                      + true.sum()), 1.0)


# ---------------------------------------------------------------- phantoms

@pytest.mark.parametrize("seed,shape", [(0, (32, 32, 4)),
                                        (10_050, (128, 128, 16)),
                                        (3, None), (10_007, None)])
def test_random_phantom_bit_equal(seed, shape):
    a = jph.make_random_phantom(seed, shape=shape)
    b = tph.make_random_phantom(seed, shape=shape)
    assert a.vox == b.vox
    for k in PHANTOM_KEYS:
        got, want = getattr(b, k), getattr(a, k)
        assert got.dtype == want.dtype and np.array_equal(got, want), k


def test_random_cohort_bit_equal():
    for got, want in zip(tph.make_random_cohort(3, (32, 48, 4), seed=5),
                         jph.make_random_cohort(3, (32, 48, 4), seed=5)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("seed,vox", [(0, None), (17, None),
                                      (4, (2.0, 2.0, 10.0))])
def test_oof_phantom_bit_equal(seed, vox):
    a = jax_oof(seed, shape=(64, 64, 8), vox=vox)
    b = torch_oof(seed, shape=(64, 64, 8), vox=vox)
    assert a[2] == b[2]
    for got, want in zip(b[:2], a[:2]):
        assert got.dtype == want.dtype and np.array_equal(got, want)


# ------------------------------------------------------------- parameters

def _numpy_params(base, seed):
    """ventjax's parameter tree at ``base`` with seeded numpy values."""
    shapes = jax.eval_shape(jseg.SegUNet(base=base).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.normal(0, 0.3, s.shape)).astype(np.float32), shapes)


@pytest.mark.parametrize("outer", [True, False])
def test_params_round_trip_exact(outer):
    tree = _numpy_params(4, 0)
    sd = tseg.params_from_flax(tree if outer else tree["params"])
    model = tseg.SegUNet(base=4)
    model.load_state_dict(sd)                 # every name and shape fits
    assert tseg.base_of(sd) == 4
    back = tseg.params_to_flax(model.state_dict())
    assert jax.tree_util.tree_structure(back) \
        == jax.tree_util.tree_structure(tree)
    for got, want in zip(_leaves(back), _leaves(tree)):
        assert got.dtype == np.float32 and np.array_equal(got, want)


def _jax_logits(params, base, x_nhw):
    return np.asarray(jseg.SegUNet(base=base).apply(
        params, jnp.asarray(x_nhw)[..., None]))


@pytest.mark.parametrize("shape", [(32, 32), (32, 48)])
def test_unet_logits_match_flax(shape):
    tree = _numpy_params(4, 1)
    model = tseg.SegUNet(base=4)
    model.load_state_dict(tseg.params_from_flax(tree))
    x = np.random.default_rng(2).random((3, *shape)).astype(np.float32)
    want = _jax_logits(tree, 4, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x)[:, None]).numpy()
    assert got.shape == want.shape == (3, *shape)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_unet_needs_multiples_of_4():
    tree = _numpy_params(2, 0)
    model = tseg.SegUNet(base=2)
    model.load_state_dict(tseg.params_from_flax(tree))
    x = np.zeros((1, 30, 32), np.float32)
    with pytest.raises(Exception):
        _jax_logits(tree, 2, x)
    with pytest.raises(ValueError, match="divisible by 4"):
        model(torch.from_numpy(x)[:, None])


def test_nearest_x2_equals_flax_resize():
    """The U-Net's upsampling at a non-square size: F.interpolate nearest
    x2 equals jax.image.resize(..., "nearest")."""
    x = np.random.default_rng(3).random((2, 3, 5, 7)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x).transpose(0, 2, 3, 1),
                                       (2, 10, 14, 3), "nearest"))
    got = F.interpolate(torch.from_numpy(x), scale_factor=2,
                        mode="nearest").numpy().transpose(0, 2, 3, 1)
    assert np.array_equal(got, want)


# ------------------------------------------------- the shipped checkpoint

@pytest.fixture(scope="module")
def shipped():
    jax_state = jseg.load_checkpoint(ORBAX)
    return jax_state, tseg.load_checkpoint(tseg.default_checkpoint_path(),
                                           device="cpu")


def test_committed_npz_equals_orbax(shipped):
    jax_state, state = shipped
    assert state.step == int(jax_state.step) == 800
    assert state.optimizer is None and state.model.base == 16
    with np.load(tseg.default_checkpoint_path()) as z:
        arrays = {k: z[k] for k in z.files}
    flat = {}

    def walk(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(f"{prefix}/{k}", v)
            else:
                flat[f"{prefix}/{k}"] = np.asarray(v)

    inner = jax_state.params
    while set(inner) == {"params"}:
        inner = inner["params"]
    walk("params", inner)
    assert sorted(arrays) == sorted(flat) + ["step"]
    assert len(flat) == 22
    for k, want in flat.items():
        assert arrays[k].dtype == want.dtype and np.array_equal(arrays[k],
                                                                want), k
    assert sum(p.numel() for p in state.model.parameters()) == 117_985


@pytest.mark.parametrize("seed", [10_000, 10_001])
def test_shipped_checkpoint_logits(shipped, seed):
    jax_state, state = shipped
    ph = tph.make_random_phantom(seed, shape=(128, 128, 16))
    got = tseg.predict_logits(state.model, ph.proton).numpy()
    x = np.transpose(ph.proton, (2, 0, 1))
    lo = x.min(axis=(1, 2), keepdims=True)
    hi = x.max(axis=(1, 2), keepdims=True)
    want = _jax_logits(jax_state.params, 16,
                       (x - lo) / np.maximum(hi - lo, 1e-6))
    assert np.abs(got - np.transpose(want, (1, 2, 0))).max() <= 1e-4
    mask = tseg.predict_mask(state.model, ph.proton).numpy()
    want_mask = np.asarray(jseg.predict_mask(
        jseg.SegUNet(base=16), jax_state.params, jnp.asarray(ph.proton)))
    assert mask.dtype == np.float32 and np.array_equal(mask, want_mask)
    assert _dice(mask, ph.mask) >= 0.9


def test_predict_mask_batch_matches_ventjax(shipped):
    """[N, H, W, D] in, [N, H, W, D] out, equal to ventjax's, and each
    volume equal to its own single-volume prediction."""
    jax_state, state = shipped
    _, _, proton = tph.make_random_cohort(2, (64, 64, 6), seed=10_030)
    got = tseg.predict_mask(state.model, proton)
    want = np.asarray(jseg.predict_mask(
        jseg.SegUNet(base=16), jax_state.params, jnp.asarray(proton)))
    assert tuple(got.shape) == proton.shape
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        tseg.predict_mask(state.model, torch.from_numpy(proton[1])).numpy(),
        want[1])


def _qc_masks(state):
    rng = np.random.default_rng(5)
    ph = tph.make_random_phantom(10_050, shape=(128, 128, 16))
    noise = rng.normal(500.0, 200.0, (128, 128, 16)).astype(np.float32)
    one_sided = np.zeros((128, 128, 16), np.float32)
    one_sided[30:90, 8:40, 4:12] = 1.0
    clipped = np.zeros((128, 128, 16), np.float32)
    clipped[:, :30, :] = 1.0
    return {
        "prediction": (tseg.predict_mask(state.model, ph.proton), ph.vox),
        "noise_prediction": (tseg.predict_mask(state.model, noise),
                             (1.5, 1.5, 10.0)),
        "speckle": ((rng.random((128, 128, 16)) < 0.05).astype(np.float32),
                    (1.5, 1.5, 10.0)),
        "empty": (np.zeros((128, 128, 16), np.float32), (1.5, 1.5, 10.0)),
        "one_sided": (one_sided, (1.5, 1.5, 10.0)),
        "clipped": (clipped, (1.5, 1.5, 10.0)),
    }


def test_mask_qc_reports_match_ventjax(shipped):
    _, state = shipped
    cases = _qc_masks(state)
    for name, (mask, vox) in cases.items():
        got = tseg.mask_qc(mask, vox)
        want = jseg.mask_qc(np.asarray(mask), vox)
        assert got == want, name
        assert got["suspect"] is (name != "prediction"), (name, got)


# ------------------------------------------------------------------ training

def _pair(base=4, shape=(32, 32), lr=1e-3):
    """ventjax's train state and the port's, from the same parameters (the
    port's init, carried across; ventjax's optimizer is optax.adam, as its
    create_train_state makes it)."""
    state = tseg.create_train_state(torch.Generator().manual_seed(0),
                                    shape=shape, base=base,
                                    learning_rate=lr, device="cpu")
    # copies: params_to_flax's arrays share the port's parameter memory,
    # which jnp.asarray may alias on the CPU, so the port's in-place steps
    # would move ventjax's parameters too
    params = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True),
                                    tseg.params_to_flax(state.params))
    tx = optax.adam(lr)
    jstate = jseg.TrainState(params=params, opt_state=tx.init(params),
                             step=jnp.zeros((), jnp.int32))
    return jseg.SegUNet(base=base), tx, jstate, state


def test_loss_and_grads_match_ventjax():
    model, _, jstate, state = _pair()
    _, mask, proton = tph.make_random_cohort(2, (32, 32, 4), seed=1)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jseg._loss_fn(
        model, p, jnp.asarray(proton), jnp.asarray(mask))))(jstate.params)
    got = tseg.loss_fn(state.model, proton, mask)
    got.backward()
    assert abs(got.item() - float(loss)) <= 1e-5 * abs(float(loss))
    tg = tseg.params_to_flax({n: p.grad for n, p in
                              state.model.named_parameters()})
    want = _leaves(grads)
    gmax = max(np.abs(g).max() for g in want)
    for g_t, g_j in zip(_leaves(tg), want):
        assert np.abs(g_t - g_j).max() <= 1e-4 * gmax


def test_three_train_steps_match_ventjax():
    model, tx, jstate, state = _pair()
    _, mask, proton = tph.make_random_cohort(2, (32, 32, 4), seed=2)
    step = jax.jit(lambda s: jseg.train_step(model, tx, s, jnp.asarray(proton),
                                             jnp.asarray(mask)))
    for i in range(3):
        jstate, want = step(jstate)
        got = tseg.train_step(state, proton, mask)
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want)), i
        for p_t, p_j in zip(_leaves(tseg.params_to_flax(state.params)),
                            _leaves(jstate.params)):
            assert np.abs(p_t - p_j).max() <= STEP_ATOL, i
    assert state.step == int(jstate.step) == 3


def test_train_step_learns():
    """The counterpart of tests/test_models.py's test_unet_train_step_learns:
    80 steps at base 4 overfit four plain phantoms."""
    _, mask, proton = tph.make_cohort(4, shape=(32, 32, 4), seed=0)
    state = tseg.create_train_state(torch.Generator().manual_seed(0),
                                    shape=(32, 32), base=4,
                                    learning_rate=3e-3, device="cpu")
    losses = [float(tseg.train_step(state, proton, mask)) for _ in range(80)]
    assert losses[-1] < losses[0] * 0.3
    pred = tseg.predict_mask(state.model, proton[0]).numpy()
    assert pred.shape == proton[0].shape
    dice = 2 * (pred * mask[0]).sum() / (pred.sum() + mask[0].sum() + 1)
    assert dice > 0.8


def test_init_is_lecun_normal():
    """flax's init: truncated at +-2 std, per-layer std within 5 % of
    sqrt(1 / fan_in) (layers of >= 2,000 weights), zero biases; the same
    seed gives the same parameters."""
    state = tseg.create_train_state(torch.Generator().manual_seed(3),
                                    shape=(32, 32), base=16, device="cpu")
    again = tseg.create_train_state(torch.Generator().manual_seed(3),
                                    shape=(32, 32), base=16, device="cpu")
    checked = 0
    for (name, p), q in zip(state.params.items(),
                            again.params.values()):
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert not p.any(), name
            continue
        fan_in = p.shape[1] * p.shape[2] * p.shape[3]
        std = np.sqrt(1.0 / fan_in)
        assert float(p.abs().max()) <= 2 * std / tseg._TRUNC_STD, name
        if p.numel() >= 2000:
            assert abs(float(p.std()) / std - 1.0) < 0.05, name
            checked += 1
    assert checked == 9


@pytest.mark.parametrize("params_only", [False, True])
def test_checkpoint_save_load(tmp_path, params_only):
    _, mask, proton = tph.make_random_cohort(2, (32, 32, 4), seed=4)
    state = tseg.create_train_state(torch.Generator().manual_seed(1),
                                    shape=(32, 32), base=4, device="cpu")
    for _ in range(2):
        tseg.train_step(state, proton, mask)
    path = tseg.save_checkpoint(str(tmp_path), state, params_only=params_only)
    assert path == str(tmp_path / tseg.CHECKPOINT_NAME)
    back = tseg.load_checkpoint(str(tmp_path), device="cpu")
    assert back.step == 2 and back.model.base == 4
    for k, v in state.params.items():
        assert torch.equal(back.params[k], v), k
    if params_only:
        assert back.optimizer is None
        return
    mu, nu, count = tseg._moments(state.optimizer, state.model)
    mu2, nu2, count2 = tseg._moments(back.optimizer, back.model)
    assert count == count2 == 2
    for k in mu:
        assert torch.equal(mu[k], mu2[k]) and torch.equal(nu[k], nu2[k]), k
    # a resumed run takes the same step as the original
    tseg.train_step(state, proton, mask)
    tseg.train_step(back, proton, mask)
    for k, v in state.params.items():
        assert torch.equal(back.params[k], v), k


def test_load_checkpoint_rejects_orbax_and_junk(tmp_path):
    with pytest.raises(ValueError, match="convert_seg_ckpt.py"):
        tseg.load_checkpoint(ORBAX, device="cpu")
    junk = tmp_path / "junk.npz"
    junk.write_bytes(b"not a zip")
    with pytest.raises(ValueError, match="not a segmentation checkpoint"):
        tseg.load_checkpoint(str(junk), device="cpu")
    with pytest.raises(FileNotFoundError):
        tseg.load_checkpoint(str(tmp_path / "absent.npz"), device="cpu")


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tseg.create_train_state(torch.Generator().manual_seed(0),
                                shape=(32, 32), base=4)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tseg.load_checkpoint(tseg.default_checkpoint_path())


def test_inference_and_training_turn_tf32_off():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        state = tseg.create_train_state(torch.Generator().manual_seed(0),
                                        shape=(16, 16), base=2, device="cpu")
        tseg.predict_mask(state.model, np.ones((16, 16, 2), np.float32))
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        tseg.train_step(state, np.ones((1, 16, 16, 2), np.float32),
                        np.ones((1, 16, 16, 2), np.float32))
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
