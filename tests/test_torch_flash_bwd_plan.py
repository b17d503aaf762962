"""Kernel 6b's launch plan on the CPU: the head groups of its dK / dV kernel
(``ops.bwd_groups``), which split the query heads that share a KV head so
that one block per SM fills the card (132 SMs: the H100 SXM)."""
import pytest

from repro_torch.kernels.flash_attention import ops as fa

N_SM = 132
# B, S, Hq, Hkv, causal, window
SHAPES = [(1, 4096, 48, 1, True, 0),       # Granite-34B-code's train_4k layer
          (1, 4096, 48, 1, False, 0), (1, 4096, 48, 1, True, 1024), (1, 2048, 32, 4, True, 0),
          (2, 8192, 32, 8, True, 0), (1, 2048, 9, 1, False, 0), (1, 257, 48, 1, True, 0),
          (1, 300, 7, 1, True, 130), (1, 1, 2, 1, True, 0)]


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_bwd_groups_fill_the_sms(shape):
    """No group is empty, groups <= Hq / Hkv, and the blocks fill the SMs
    as far as a split can: at least one block per SM, or every head its own
    group, or the choice ends strictly sooner than every split that gives
    one block per SM (a 9-head split of 5 groups of at most 2 heads beats
    9 groups in two waves); and no group count ends the schedule sooner."""
    B, S, Hq, Hkv, causal, window = shape
    G = Hq // Hkv
    groups = fa.bwd_groups(B, S, Hq, Hkv, N_SM, causal, window)
    per = -(-G // groups)
    assert 1 <= groups <= G and (groups - 1) * per < G     # the kernel's split, none empty
    tiles = -(-S // fa.BWD_KEY_TILE) * B * Hkv
    ends = {g: fa.dkdv_schedule(B, S, Hq, Hkv, N_SM, causal, window, g)[0]
            for g in range(1, G + 1)}
    assert (tiles * groups >= N_SM or groups == G
            or all(ends[groups] < e for g, e in ends.items() if tiles * g >= N_SM)), ends
    assert ends[groups] == min(ends.values())


def test_bwd_groups_at_granite_train_layer():
    """At one train_4k micro-batch's layer (S = 4,096, 48 heads over one KV
    head, causal): 8 groups of 6 heads, 256 blocks over 132 SMs, the
    schedule within 2% of its lower bound (the summed cost over the SMs,
    or the heaviest block)."""
    groups = fa.bwd_groups(1, 4096, 48, 1, N_SM)
    assert groups == 8
    assert -(-4096 // fa.BWD_KEY_TILE) * groups == 256
    end, work = fa.dkdv_schedule(1, 4096, 48, 1, N_SM, True, 0, groups)
    heaviest = 6 * 4096 // fa.BWD_ROW_TILE + fa.BWD_BLOCK_COST
    assert end <= 1.02 * max(work / N_SM, heaviest)
