"""The work the shares divide by: ``counts.py`` against a hand count at
``hrnet_tiny``'s shapes, and the figures frozen in the configurations."""

import pytest

from h100_bench import counts, harness

TINY = dict(in_channels=1, num_keypoints=6, stem_channels=8,
            widths=[8, 16, 32, 64], blocks=[1, 1, 1, 1], with_cbam=True,
            crop_size=16)


def _conv(cin, cout, k, hw):
    return 2 * cin * cout * k * k * hw * hw


def hand_forward(c: dict) -> int:
    """Every convolution of the network at crop size S (stride-2 stem:
    the body runs at S/2, branch b at S/2^(b+1))."""
    S, st, w, K = c['crop_size'], c['stem_channels'], c['widths'], \
        c['num_keypoints']
    n = _conv(c['in_channels'], st, 3, S) + _conv(st, st, 3, S // 2)

    def cbam(ch, hw):
        hid = max(ch // 16, 1)
        # the shared MLP on the stacked average and max vectors
        return 2 * (2 * ch * hid + 2 * hid * ch) + _conv(2, 1, 7, hw)

    def block(cin, ch, hw):
        out = _conv(cin, ch, 3, hw) + _conv(ch, ch, 3, hw) + cbam(ch, hw)
        if cin != ch:
            out += _conv(cin, ch, 1, hw)
        return out

    hw = [S // 2 ** (b + 1) for b in range(4)]
    n += block(st, w[0], hw[0])
    for _ in range(c['blocks'][0] - 1):
        n += block(w[0], w[0], hw[0])
    for stage in range(1, 4):
        nb = stage + 1
        # transition: the new branch from the last, stride 2
        n += _conv(w[stage - 1], w[stage], 3, hw[stage])
        for b in range(nb):
            n += c['blocks'][stage] * block(w[b], w[b], hw[b])
        for i in range(nb):
            for j in range(nb):
                if j > i:
                    n += _conv(w[j], w[i], 1, hw[j])
                for k in range(i - j):
                    last = k == i - j - 1
                    n += _conv(w[j], w[i] if last else w[j], 3,
                               hw[j + k + 1])
    total = sum(w)
    n += _conv(total, total, 3, hw[0]) + _conv(total, K, 1, hw[0])
    n += cbam(st, S) + _conv(K + st, K, 3, S)
    # the head's align-corners resizes: two products per map
    n += 2 * (hw[0] * S * K * hw[0]) + 2 * (S * S * K * hw[0])
    return n


def test_forward_hand_count():
    assert counts.forward_flops(TINY) == hand_forward(TINY)
    assert counts.forward_flops(TINY, 3) == 3 * hand_forward(TINY)


def test_train_about_three_forwards():
    """Backward costs two forwards (input and weight gradients), less the
    first conv's input gradient."""
    f, t = counts.forward_flops(TINY), counts.train_flops(TINY)
    first = _conv(1, TINY['stem_channels'], 3, TINY['crop_size'])
    assert 2.9 * f < t <= 3 * f
    assert t >= 3 * f - first - 4 * f // 100


def test_k1_bytes():
    assert counts.k1_bytes(256, 128, 30) == 256 * 128 * 128 * 30 * 4 \
        + 256 * 30 * 12


@pytest.mark.parametrize('name,key,fn', [
    ('hrnet_esa_serve', 'flops_forward_per_image', counts.forward_flops),
    ('hrnet_esa_train', 'flops_train_per_image', counts.train_flops)])
def test_frozen_figures(name, key, fn):
    cfg = harness.config(name)
    assert cfg[key] == fn(cfg)
