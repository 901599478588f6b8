"""Proton -> lung-mask segmentation model (U-Net), its training step and
its inference, on the card.

The port of ``ventjax/models/segmentation.py``.  A compact 2-D U-Net is
applied slice-wise to [N, H, W, D] proton volumes; ``analyze --auto-mask``
predicts the lung mask with it, ``mask_qc`` checks that mask's
plausibility on the host, and ``train-seg`` trains it on the
domain-randomized phantoms of ``ventjax_torch.io.phantom``.

The network computes what the reference's flax module computes, in
PyTorch's layout: NCHW activations and OIHW kernels (flax keeps NHWC and
HWIO; ``params_from_flax`` and ``params_to_flax`` carry a parameter tree
across), the tanh form of GELU (flax's ``nn.gelu`` default), SAME 3x3
convolutions, VALID 2x2 average pools, x2 nearest upsampling and skips
concatenated as [upsampled, skip].  The objective (mean BCE-with-logits +
mean soft-Dice) and the optimizer (Adam, optax's defaults) are the
reference's; the initialisation is flax's (lecun_normal kernels, zero
biases) drawn from an explicit ``torch.Generator``.

The convolutions are cuDNN's: no Pallas kernel lies in the reference's
model, which XLA compiles.  ``predict_mask`` and ``train_step`` turn TF32
off for convolutions and products, since its ~3 digits would flip mask
voxels near the threshold.

Checkpoints are one ``.npz`` (the reference's orbax directories need
orbax, which the card's machine lacks): flax path names as keys, kernels
in HWIO, ``step``, and Adam's moments and count unless ``params_only``.
``scripts/convert_seg_ckpt.py`` converts an orbax checkpoint of the
reference package; the shipped artifact is ``models/seg_ckpt.npz``.

``make_sharded_train_step`` runs the train step over a ("batch",
"space") mesh: lanes over batch rows, H-slabs of each slice over space
shards, with the convolutions' halos and the loss's sums written out.
"""
from __future__ import annotations

import dataclasses
import math
import os
import zipfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ventjax_torch.utils.device import resolve_device

#: File name of a checkpoint inside a directory (``train-seg --out DIR``).
CHECKPOINT_NAME = "seg_ckpt.npz"
#: lecun_normal draws a normal truncated at +-2 std, rescaled by this
#: factor (the std of the unit normal truncated at +-2) to keep its
#: variance 1 / fan_in (flax's variance_scaling).
_TRUNC_STD = 0.87962566103423978


class _ConvBlock(nn.Module):
    """Two SAME 3x3 convolutions with bias, each followed by tanh-GELU."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv0 = nn.Conv2d(cin, features, 3, padding=1)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        x = F.gelu(self.conv0(x), approximate="tanh")
        return F.gelu(self.conv1(x), approximate="tanh")


class SegUNet(nn.Module):
    """2-D U-Net over [S, 1, H, W] slices -> [S, H, W] logits.

    Widths base, 2 base and 4 base; H and W must be multiples of 4 (two
    VALID 2x2 pools; nothing is padded, as in the reference)."""

    def __init__(self, base: int = 16):
        super().__init__()
        self.base = base
        self.blocks = nn.ModuleList([
            _ConvBlock(1, base),
            _ConvBlock(base, 2 * base),
            _ConvBlock(2 * base, 4 * base),
            _ConvBlock(4 * base + 2 * base, 2 * base),
            _ConvBlock(2 * base + base, base),
        ])
        self.head = nn.Conv2d(base, 1, 1)

    def forward(self, x):
        if x.shape[-2] % 4 or x.shape[-1] % 4:
            raise ValueError(f"SegUNet needs H and W divisible by 4 (two 2x2 "
                             f"pools); got {tuple(x.shape[-2:])}")
        b = self.blocks
        c1 = b[0](x)
        c2 = b[1](F.avg_pool2d(c1, 2))
        c3 = b[2](F.avg_pool2d(c2, 2))
        u2 = F.interpolate(c3, scale_factor=2, mode="nearest")
        c4 = b[3](torch.cat([u2, c2], dim=1))
        u1 = F.interpolate(c4, scale_factor=2, mode="nearest")
        c5 = b[4](torch.cat([u1, c1], dim=1))
        return self.head(c5)[:, 0]


# ---------------------------------------------------------------------------
# Parameters: flax's tree <-> the port's state_dict
# ---------------------------------------------------------------------------

def _flax_names(n_blocks: int = 5):
    """(flax module path, state_dict prefix) of every convolution."""
    pairs = [(f"_ConvBlock_{i}/Conv_{j}", f"blocks.{i}.conv{j}")
             for i in range(n_blocks) for j in range(2)]
    return pairs + [("Conv_0", "head")]


def params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree (numpy or jax arrays) as SegUNet's
    state_dict (float32 CPU tensors): kernels HWIO -> OIHW.  Accepts the
    tree with or without its outer ``"params"`` key."""
    while set(tree) == {"params"}:
        tree = tree["params"]
    sd = {}
    for path, prefix in _flax_names():
        mod, conv = path.rsplit("/", 1) if "/" in path else (None, path)
        leaf = tree[mod][conv] if mod else tree[conv]
        kernel = np.asarray(leaf["kernel"], np.float32)
        sd[f"{prefix}.weight"] = torch.from_numpy(
            np.array(kernel.transpose(3, 2, 0, 1), order="C"))
        sd[f"{prefix}.bias"] = torch.from_numpy(
            np.array(leaf["bias"], np.float32))
    return sd


def params_to_flax(state_dict) -> Dict:
    """SegUNet's state_dict as the reference's parameter tree
    ``{"params": {...}}`` of numpy arrays (kernels OIHW -> HWIO), the form
    ``SegUNet.apply`` of the reference takes."""
    inner: Dict = {}
    for path, prefix in _flax_names():
        w = state_dict[f"{prefix}.weight"].detach().cpu().numpy()
        leaf = {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
                "bias": state_dict[f"{prefix}.bias"].detach().cpu().numpy()}
        node = inner
        for part in path.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[path.split("/")[-1]] = leaf
    return {"params": inner}


def base_of(state_dict) -> int:
    """The U-Net base width a state_dict was made for."""
    return int(state_dict["head.weight"].shape[1])


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """The model, its optimizer (None for a params-only checkpoint) and the
    number of steps taken.  ``train_step`` updates it in place."""
    model: SegUNet
    optimizer: Optional[torch.optim.Adam]
    step: int = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.model.state_dict()


def _exact_float32():
    """Full float32 convolutions and products on the card (TF32 keeps ~3
    digits, which moves logits near the mask threshold)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _init_flax(model: SegUNet, generator: torch.Generator) -> None:
    """flax's initialisation: lecun_normal kernels (a normal truncated at
    +-2, std sqrt(1 / fan_in) / 0.8796), zero biases.  Drawn on the CPU,
    so a seed gives the same parameters on every device."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight.shape[1] * m.weight.shape[2] \
                    * m.weight.shape[3]
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                m.weight.copy_(w)
                m.bias.zero_()


def _adam(model: SegUNet, learning_rate: float) -> torch.optim.Adam:
    """optax.adam's update: b1 0.9, b2 0.999, eps 1e-8 outside the root."""
    return torch.optim.Adam(model.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def create_train_state(
    generator: torch.Generator,
    shape: Tuple[int, int] = (128, 128),
    base: int = 16,
    learning_rate: float = 1e-3,
    device="cuda",
) -> TrainState:
    """A freshly initialised U-Net on ``device`` with its Adam optimizer.

    ``shape`` is the slice shape the model will train on; like the
    reference (whose init traces one such slice) it must be divisible by
    4.  ``generator`` is a CPU ``torch.Generator`` seeded by the caller."""
    dev = resolve_device(device)
    if shape[0] % 4 or shape[1] % 4:
        raise ValueError(f"SegUNet needs H and W divisible by 4; got {shape}")
    model = SegUNet(base=base)
    _init_flax(model, generator)
    model.to(dev)
    return TrainState(model=model, optimizer=_adam(model, learning_rate))


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _as_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _slices(vol4d: torch.Tensor) -> torch.Tensor:
    """[N, H, W, D] -> [N*D, 1, H, W] slice batch."""
    n, h, w, d = vol4d.shape
    return vol4d.permute(0, 3, 1, 2).reshape(n * d, 1, h, w)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """Per-slice min/max normalisation with the reference's 1e-6 floor."""
    lo = x.amin(dim=(1, 2, 3), keepdim=True)
    hi = x.amax(dim=(1, 2, 3), keepdim=True)
    return (x - lo) / torch.clamp(hi - lo, min=1e-6)


def loss_fn(model: SegUNet, proton, mask) -> torch.Tensor:
    """Mean BCE-with-logits plus mean soft-Dice (+1 smoothing) over the
    normalised slices of [N, H, W, D] proton and mask volumes."""
    dev = _device_of(model)
    x = _normalize(_slices(_as_tensor(proton, dev)))
    y = _slices(_as_tensor(mask, dev))[:, 0]
    logits = model(x)
    bce = F.binary_cross_entropy_with_logits(logits, y)
    p = torch.sigmoid(logits)
    inter = (p * y).sum(dim=(1, 2))
    dice = 1.0 - (2 * inter + 1.0) / (p.sum(dim=(1, 2)) + y.sum(dim=(1, 2))
                                      + 1.0)
    return bce + dice.mean()


def train_step(state: TrainState, proton, mask) -> torch.Tensor:
    """One Adam step on a [N, H, W, D] batch; updates ``state`` in place
    and returns the loss before the step (a detached scalar tensor)."""
    _exact_float32()
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(state.model, proton, mask)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return loss.detach()


def _conv_slabs(xs, w, b):
    """A SAME 3x3 convolution of the image the slabs ``xs`` ([S, C, h, W]
    each, H-slabs in order) make up: each slab takes one halo row from
    either neighbour (zeros beyond the image's edges) and pads W itself.
    Autograd carries the adjoint back through the halo copies."""
    from ventjax_torch.dist import space

    return [F.conv2d(p, wi, bi, padding=(0, 1))
            for p, wi, bi in zip(space.with_halo(xs, 1, dim=2), w, b)]


def _forward_slabs(params, xs):
    """SegUNet's forward over H-slabs; ``params[k]`` holds shard k's copy of
    every parameter (names as in the state_dict)."""
    def block(i, ys):
        for j in range(2):
            key = f"blocks.{i}.conv{j}"
            ys = [F.gelu(y, approximate="tanh") for y in _conv_slabs(
                ys, [p[key + ".weight"] for p in params],
                [p[key + ".bias"] for p in params])]
        return ys

    pool = lambda ys: [F.avg_pool2d(y, 2) for y in ys]
    up = lambda ys: [F.interpolate(y, scale_factor=2, mode="nearest")
                     for y in ys]
    cat = lambda a, b: [torch.cat([x, y], dim=1) for x, y in zip(a, b)]
    c1 = block(0, xs)
    c2 = block(1, pool(c1))
    c3 = block(2, pool(c2))
    c4 = block(3, cat(up(c3), c2))
    c5 = block(4, cat(up(c4), c1))
    return [F.conv2d(c, p["head.weight"], p["head.bias"])[:, 0]
            for c, p in zip(c5, params)]


def make_sharded_train_step(state: TrainState, mesh):
    """The train step over a ("batch", "space") mesh
    (``dist.make_batch_space_mesh``, or ``dist.make_rank_space_mesh`` over
    torch.distributed ranks): the counterpart of ventjax's
    ``make_sharded_train_step(model, tx, mesh)``.

    Returns ``step(state, proton, mask) -> loss``, which, like
    ``train_step``, updates ``state`` in place (the port's TrainState holds
    the model and its optimizer, where ventjax's step returns a new state
    with the loss).  ``state`` names the model the step will train; every
    call takes its state.

    Batch rows take lanes and space shards take H-slabs of each slice (the
    slab height a multiple of 4, for the U-Net's two 2x2 VALID pools).
    Every SAME 3x3 convolution takes 1-row halos from its neighbours;
    pools, x2 upsampling, the concatenations and the 1x1 head stay local.
    Each slice's min and max for the normalisation, BCE's sum and Dice's
    per-slice sums are combined across shards.  The parameters and Adam's
    state stay replicated: each shard computes with its own copy, the
    shards' gradients are summed in one fixed order (shard order, batch
    row by batch row) and one Adam step updates the model, as every
    replica would alike.  In one process the shards run in turn.  Over
    ranks every rank calls the step with the whole batch and its own
    model: the halos' gradients travel back to the ranks they came from,
    every rank sums the all_gathered gradients in that order, and the
    parameters stay bit-identical across ranks."""
    import contextlib

    from ventjax_torch.dist import space
    from ventjax_torch.dist.mesh import (
        BatchSpaceMesh, RankSpaceMesh, _per_shard,
    )

    if not isinstance(mesh, (BatchSpaceMesh, RankSpaceMesh)):
        raise TypeError("make_sharded_train_step takes a ('batch', 'space') "
                        "mesh from dist.make_batch_space_mesh or "
                        "dist.make_rank_space_mesh")
    if not isinstance(state, TrainState) or state.optimizer is None:
        raise TypeError("make_sharded_train_step needs a TrainState with "
                        "its optimizer (not a params-only checkpoint)")
    ranked = isinstance(mesh, RankSpaceMesh)
    if ranked:
        rows = [(mesh.row, (mesh.device,))]
        on_row = lambda: space.on_ranks(mesh.row_ranks)
        on_all = lambda: space.on_ranks(mesh.all_ranks)
    else:
        rows = list(enumerate(mesh.devices))
        on_row = on_all = contextlib.nullcontext
    shards = [d for _, row in rows for d in row]

    def step(state: TrainState, proton, mask) -> torch.Tensor:
        _exact_float32()
        model = state.model
        model.train()
        first = shards[0]
        hp = _as_tensor(proton, first)
        y = _as_tensor(mask, first)
        n, H = hp.shape[0], hp.shape[1]
        h = space.slab_height(hp.shape[1:], mesh.n_space)
        if h % 4:
            raise ValueError(
                f"a slab of {h} rows (H {H} over {mesh.n_space} space "
                f"shards) does not take the U-Net's two 2x2 pools; the "
                f"slab height must be a multiple of 4")
        per = _per_shard(n, mesh.n_batch)
        named = list(model.named_parameters())
        params = [{k: p.detach().to(d).requires_grad_(True)
                   for k, p in named} for d in shards]
        bce_sums, dices = [], []
        for i, (b, row) in enumerate(rows):
            lanes = slice(b * per, (b + 1) * per)
            with on_row():
                xs = space.split_rows(_slices(hp[lanes]), row, dim=2)
                ys = [t[:, 0] for t in
                      space.split_rows(_slices(y[lanes]), row, dim=2)]
                lo = space.reduce_min([x.amin(dim=(1, 2, 3)) for x in xs])
                hi = space.reduce_max([x.amax(dim=(1, 2, 3)) for x in xs])
                scale = torch.clamp(hi - lo, min=1e-6)
                xs = [(x - space.to(lo, x.device)[:, None, None, None])
                      / space.to(scale, x.device)[:, None, None, None]
                      for x in xs]
                ps = params[i * len(row):(i + 1) * len(row)]
                logits = _forward_slabs(ps, xs)
                bce_sums += [F.binary_cross_entropy_with_logits(
                    lg, t, reduction="sum") for lg, t in zip(logits, ys)]
                prob = [torch.sigmoid(lg) for lg in logits]
                inter = space.sum_in_order([(p * t).sum(dim=(1, 2))
                                            for p, t in zip(prob, ys)])
                psum = space.sum_in_order([p.sum(dim=(1, 2)) for p in prob])
                ysum = space.sum_in_order([t.sum(dim=(1, 2)) for t in ys])
            dices.append((1.0 - (2 * inter + 1.0) / (psum + ysum + 1.0)
                          ).to(first))
        with on_all():
            bce = space.sum_in_order(bce_sums).to(first)
        if ranked:
            # each row's Dice from its first rank, this rank's own (live)
            got = space.all_gather(dices[0], mesh.all_ranks)
            dices = [got[mesh.rank if b == mesh.row else b * mesh.n_space]
                     for b in range(mesh.n_batch)]
        loss = bce / hp.numel() + torch.cat(dices).mean()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        with torch.no_grad():
            flat = [torch.cat([q[k].grad.reshape(-1) for k, _ in named])
                    for q in params]
            with on_all():
                total = space.sum_in_order(flat).to(first)
            off = 0
            for k, p in named:
                p.grad = total[off:off + p.numel()].view_as(p)
                off += p.numel()
        state.optimizer.step()
        state.step += 1
        return loss.detach()

    return step


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------

@torch.no_grad()
def predict_logits(model: SegUNet, proton, device=None) -> torch.Tensor:
    """[H, W, D] or [N, H, W, D] proton -> float32 logits of the same
    shape, on ``device`` (default: the model's; another device moves the
    model there)."""
    _exact_float32()
    dev = _device_of(model) if device is None else resolve_device(device)
    model.eval()
    vol = _as_tensor(proton, dev)
    single = vol.dim() == 3
    if single:
        vol = vol[None]
    n, h, w, d = vol.shape
    logits = model.to(dev)(_normalize(_slices(vol)))
    logits = logits.reshape(n, d, h, w).permute(0, 2, 3, 1)
    return logits[0] if single else logits


def predict_mask(model: SegUNet, proton, thresh: float = 0.5,
                 device=None) -> torch.Tensor:
    """[H, W, D] or [N, H, W, D] proton -> binary float32 mask of the same
    shape, on ``device`` (default: the model's): ``sigmoid(logits) >
    thresh``, as the reference thresholds (in float32 a tiny logit's
    sigmoid rounds to 0.5, so this is not ``logits > 0``)."""
    logits = predict_logits(model, proton, device=device)
    return (torch.sigmoid(logits) > thresh).to(torch.float32)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def default_checkpoint_path() -> str:
    """The shipped domain-randomized segmentation artifact (analyze
    --auto-mask uses it when --seg-ckpt is not given)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        CHECKPOINT_NAME)


def _flat(prefix: str, tree: Dict) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(f"{prefix}/{k}", v))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _moments(optimizer: torch.optim.Adam, model: SegUNet):
    """Adam's first and second moments as state_dicts of the model's
    parameter names, and its step count."""
    mu, nu, count = {}, {}, 0
    for name, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        mu[name] = st.get("exp_avg", torch.zeros_like(p))
        nu[name] = st.get("exp_avg_sq", torch.zeros_like(p))
        count = int(st.get("step", count))
    return mu, nu, count


def save_checkpoint(path: str, state: TrainState,
                    params_only: bool = False) -> str:
    """Write ``state`` to ``path`` (one .npz, written whole or not at all)
    under the reference's flax path names, kernels in HWIO.  With
    ``params_only`` Adam's state is left out (the shipped artifact's form,
    a third of the size).  A directory ``path`` gets
    ``path/seg_ckpt.npz``.  Returns the file written."""
    if os.path.isdir(path):
        path = os.path.join(path, CHECKPOINT_NAME)
    arrays = _flat("params", params_to_flax(state.params)["params"])
    arrays["step"] = np.asarray(state.step, np.int64)
    if not params_only and state.optimizer is not None:
        mu, nu, count = _moments(state.optimizer, state.model)
        arrays.update(_flat("opt_state/mu", params_to_flax(mu)["params"]))
        arrays.update(_flat("opt_state/nu", params_to_flax(nu)["params"]))
        arrays["opt_state/count"] = np.asarray(count, np.int64)
        arrays["opt_state/lr"] = np.asarray(
            state.optimizer.param_groups[0]["lr"], np.float64)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def _tree(arrays, prefix: str) -> Dict:
    """The nested tree of the arrays whose keys start with ``prefix/``."""
    tree: Dict = {}
    for key, a in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = a
    return tree


def _checkpoint_file(path: str) -> str:
    if os.path.isdir(path):
        inner = os.path.join(path, CHECKPOINT_NAME)
        if os.path.isfile(inner):
            return inner
        raise ValueError(
            f"{path} is a directory without {CHECKPOINT_NAME}: the port's "
            "segmentation checkpoint is one .npz; an orbax checkpoint of the "
            "reference package converts with scripts/convert_seg_ckpt.py")
    return path


def load_checkpoint(path: str, device="cuda") -> TrainState:
    """Restore a checkpoint onto ``device``: the model in eval mode at the
    checkpoint's width and, where the file holds Adam's state, its
    optimizer with the moments and step count restored (else None; fine
    for inference).  ``path`` is the .npz or a directory holding
    ``seg_ckpt.npz``; an orbax directory raises a ValueError naming the
    converter."""
    dev = resolve_device(device)
    path = _checkpoint_file(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no segmentation checkpoint at {path}")
    try:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
    except (zipfile.BadZipFile, ValueError, OSError) as e:
        raise ValueError(f"{path} is not a segmentation checkpoint (.npz): "
                         f"{e}") from e
    if "params/Conv_0/kernel" not in arrays:
        raise ValueError(f"{path} holds no SegUNet parameters "
                         "(no params/Conv_0/kernel)")
    params = params_from_flax(_tree(arrays, "params"))
    model = SegUNet(base=base_of(params))
    model.load_state_dict(params)
    model.to(dev).eval()
    optimizer = None
    if "opt_state/count" in arrays:
        optimizer = _adam(model, float(arrays["opt_state/lr"]))
        mu = params_from_flax(_tree(arrays, "opt_state/mu"))
        nu = params_from_flax(_tree(arrays, "opt_state/nu"))
        count = int(arrays["opt_state/count"])
        if count > 0:
            for name, p in model.named_parameters():
                optimizer.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": mu[name].to(dev),
                    "exp_avg_sq": nu[name].to(dev)}
    return TrainState(model=model, optimizer=optimizer,
                      step=int(arrays["step"]))


# ---------------------------------------------------------------------------
# Inference-time mask QC
# ---------------------------------------------------------------------------

def mask_qc(
    mask,
    vox,
    volume_bounds_l=(0.2, 13.0),
    max_major_components: int = 2,
    stray_fraction_max: float = 0.05,
    edge_fraction_max: float = 0.01,
    asymmetry_max: float = 0.6,
) -> dict:
    """Plausibility checks for a (predicted) lung mask — warn, never fail.

    The shipped U-Net checkpoint is validated on held-out draws of its own
    phantom generator; on out-of-family anatomy a silently wrong mask would
    propagate into every metric with valid=True.  This gate catches the
    gross failure modes cheaply on the host:

    - total volume outside physiologic bounds (default 0.2-13 liters —
      generous so hand masks of children/pathology never false-alarm);
    - more than ``max_major_components`` connected components holding >=1%
      of the mask each (two lungs, possibly fused at the carina -> 1-2),
      or >``stray_fraction_max`` of voxels outside the two largest
      components (speckle = classic segmentation failure);
    - mask clipped by the FOV: >``edge_fraction_max`` of mask voxels on
      the in-plane faces of the volume;
    - gross left/right asymmetry: the mask split at the volume's midline
      column differs by more than ``asymmetry_max`` of the total.

    Returns {"suspect": bool, "reasons": [str...], "stats": {...}}, the
    reference package's report for the same mask — the CLI surfaces it as
    metadata["automask_suspect"] and warns; it does NOT fail the run (an
    unusual patient is not an error).  Connected-component checks need
    scipy.ndimage; without scipy they are skipped.
    """
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    m = np.asarray(mask) > 0
    reasons = []
    stats = {}
    n = int(m.sum())
    vox_cc = float(np.prod(np.asarray(vox, np.float64))) / 1000.0
    volume_l = n * vox_cc / 1000.0
    stats["volume_l"] = volume_l
    if n == 0:
        return {"suspect": True, "reasons": ["mask is empty"], "stats": stats}
    if not volume_bounds_l[0] <= volume_l <= volume_bounds_l[1]:
        reasons.append(
            f"lung volume {volume_l:.2f} L outside plausible bounds "
            f"[{volume_bounds_l[0]:g}, {volume_bounds_l[1]:g}] L")

    try:
        from scipy import ndimage

        labels, n_comp = ndimage.label(m)
        sizes = np.sort(np.bincount(labels.reshape(-1))[1:])[::-1]
        major = int((sizes >= 0.01 * n).sum())
        stray = 1.0 - float(sizes[:2].sum()) / n
        stats["components"] = int(n_comp)
        stats["major_components"] = major
        stats["stray_fraction"] = stray
        if major > max_major_components:
            reasons.append(
                f"{major} major connected components (>{max_major_components}"
                "); a lung mask has at most two")
        if stray > stray_fraction_max:
            reasons.append(
                f"{stray:.1%} of mask voxels outside the two largest "
                f"components (>{stray_fraction_max:.0%}): speckle")
    except ImportError:  # pragma: no cover - scipy is normally present
        pass

    # In-plane faces only: thin-slab chest acquisitions legitimately have
    # lung on the first/last SLICE, but lung on the in-plane image border
    # means the FOV clipped it (or the mask leaked into background).
    edge = np.zeros_like(m)
    for ax in (0, 1):
        sl = [slice(None)] * 3
        for end in (0, -1):
            sl[ax] = end
            edge[tuple(sl)] = True
    edge_frac = float((m & edge).sum()) / n
    stats["edge_fraction"] = edge_frac
    if edge_frac > edge_fraction_max:
        reasons.append(
            f"{edge_frac:.1%} of mask voxels on the in-plane FOV boundary "
            f"(>{edge_fraction_max:.0%}): mask clipped or leaked to the edge")

    # Split at the VOLUME midline (not the mask centroid — a one-sided
    # mask is perfectly balanced around its own centroid): chest
    # acquisitions center the patient, so a mask living overwhelmingly on
    # one side of the image means a lung is missing from the prediction.
    cols = np.where(m.any(axis=(0, 2)))[0]
    mid = m.shape[1] // 2
    left = int(m[:, :mid, :].sum())
    right = n - left
    asym = abs(left - right) / n
    stats["asymmetry"] = asym
    stats["col_span"] = [int(cols[0]), int(cols[-1])]
    if asym > asymmetry_max:
        reasons.append(
            f"left/right split {left}/{right} voxels about the image "
            f"midline ({asym:.0%} asymmetric, >{asymmetry_max:.0%}): "
            "a lung may be missing")

    return {"suspect": bool(reasons), "reasons": reasons, "stats": stats}
