"""K10's window of balls (``ops/ci_cuda.py:tail_window``) on an H100's
limits: the widest window at which four blocks share an SM by the
shared-memory arithmetic, never past the card's caps, covering every
ball; fewer blocks only where the registers force them.  The kernel
itself is held to its plain version on the card
(``tests/test_torch_cuda.py``)."""
import pytest
import torch

from ventjax_torch.ops import ci_cuda
from ventjax_torch.ops.ci_cuda import (
    NARROW_KW, SMEM_UNIT, TAIL_BLOCKS, TailLimits, tail_smem, tail_window)

# An H100 80GB HBM3 (sm_90): 228 KiB of shared memory an SM, 227 KiB a
# block by opt-in, 1 KiB reserved a block; 64K registers and 2,048 threads
# an SM; the kernel at its launch bound of 64 registers, 16 B static.
H100 = TailLimits(smem_sm=233472, smem_block=232448, smem_reserved=1024,
                  regs_sm=65536, threads_sm=2048, regs=64, smem_static=16)


def _per_block(bins, wide, lim):
    """Shared memory one block holds on an SM at a window of bins."""
    own = tail_smem(bins, wide) + lim.smem_static
    return -(-own // SMEM_UNIT) * SMEM_UNIT + lim.smem_reserved


@pytest.mark.parametrize("Kw", [8192, 32768, 65536])
@pytest.mark.parametrize("nb", [875, 2243])
def test_window_lets_four_blocks_share_an_sm(nb, Kw):
    wide = Kw >= NARROW_KW
    bins, blocks = tail_window(nb, wide, H100)
    assert blocks == TAIL_BLOCKS == 4
    assert 1 <= bins <= nb
    assert blocks * _per_block(bins, wide, H100) <= H100.smem_sm
    assert tail_smem(bins, wide) + H100.smem_static <= H100.smem_block
    # the widest such window: one more ball would cost a block
    assert blocks * _per_block(bins + 1, wide, H100) > H100.smem_sm
    # the windows cover every ball, 16-bit counts in fewer of them
    windows = -(-nb // bins)
    assert windows * bins >= nb > (windows - 1) * bins
    assert bins == (766 if not wide else 406)


@pytest.mark.parametrize("nb", [1, 95, 600])
def test_window_holds_all_balls_where_they_fit(nb):
    bins, blocks = tail_window(nb, False, H100)
    assert (bins, blocks) == (nb, TAIL_BLOCKS)


@pytest.mark.parametrize("regs, blocks",
                         [(72, 3), (128, 2), (255, 1), (32, 4)])
def test_registers_cap_blocks_not_the_window_rule(regs, blocks):
    lim = H100._replace(regs=regs)
    bins, got = tail_window(2243, False, lim)
    assert got == blocks
    assert got * _per_block(bins, False, lim) <= lim.smem_sm
    assert tail_smem(bins, False) + lim.smem_static <= lim.smem_block


def test_no_resident_warps_counted_on_the_cpu():
    from ventjax_torch.ops import ci_pairwise as tcp

    geom = tcp.build_ci_pairwise_geometry((1.5, 1.5, 10.0), (16, 16, 4), 8,
                                          "wrap")
    pts = tuple(torch.tensor([[1, 5, 9]], dtype=torch.int32) for _ in range(3))
    r2, T = tcp._tail_tables(geom, 3)
    before = dict(ci_cuda.LAUNCHES)
    ci_cuda.tail_balls(pts, pts, torch.as_tensor(r2), torch.as_tensor(T),
                       tcp._alias_combos(geom), geom.scale, geom.rmax)
    got = {k: v - before[k] for k, v in ci_cuda.LAUNCHES.items()}
    assert got["alias_min_d2_rows"] == 3
    assert got["tail_balls"] == got["tail_balls_resident_warps"] == 0
