"""Kernels K1, K2, K3a-c, K4 and the embedding gradient on the card against
their plain twins (needs a CUDA device).

Marked `cuda`; skips on a host without a card. On a machine with one, and
without JAX (tests/conftest.py imports JAX unless TPU_DEER_TEST_TPU is set):

    TPU_DEER_TEST_TPU=1 python -m pytest tests/test_torch_kernels_cuda.py -q

Tolerances as between the reference's own front-end paths (float32 sums in
another order: the kernels' FFT against the plain twins' dense DFT
products); ZCR counts sign changes and must be equal, and K1 and K2 repeat
bit for bit. K3: rtol 1e-4,
atol 2e-5 (float32 FMAs in another order than the plain twin's cuBLAS
GEMMs, over up to 300 keys). K4: equal int8 values and scale bits (the
same words, IEEE division). The embedding gradient: rtol 1e-5, atol 1e-3
against the plain twin in float64 (a float32 sum of up to ~130,000 rows of
one id, taken in pieces of 64); bit for bit against a second run. Also
on the card: remat's graphed fused steps against its eager steps, bit for
bit (the recomputation's dropout draws under a CUDA graph).
"""

import numpy as np
import pytest
import torch

from tpu_deer_torch import stream as tstream
from tpu_deer_torch.data.vocab import PAD_ID
from tpu_deer_torch.kernels import embedding as emb
from tpu_deer_torch.kernels import flash_attention as k3
from tpu_deer_torch.kernels import mfcc_frames as k2
from tpu_deer_torch.kernels import quantize_int8 as k4
from tpu_deer_torch.kernels.mfcc_signal import mfcc_signal, mfcc_signal_plain
from tpu_deer_torch.models.deer_model import create_complete_deer_model
from tpu_deer_torch.ops import audio_frontend as taf

pytestmark = pytest.mark.cuda

TOL = ((2e-3, 5e-3), (2e-4, 1e-3), (2e-4, 1e-3), (1e-4, 1e-5))


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("b,n", [(1, 32000), (3, 48017)])
def test_kernel_matches_plain(device, b, n):
    rng = np.random.default_rng(b)
    t = np.arange(n) / 16000.0
    sig = np.stack([0.3 * np.sin(2 * np.pi * (100 + 50 * i) * t)
                    + 0.02 * rng.normal(size=n) for i in range(b)])
    cfg = taf.AudioFrontendConfig()
    x_pad, _ = taf._pad_for_frames(
        torch.from_numpy(sig.astype(np.float32)).to(device), cfg)
    bases = taf._device_bases(cfg, device)
    before = mfcc_signal.launches
    got = mfcc_signal(x_pad, bases, cfg.n_fft, cfg.hop_length)
    torch.cuda.synchronize()
    assert mfcc_signal.launches == before + 1
    ref = mfcc_signal_plain(x_pad, bases, cfg.n_fft, cfg.hop_length)
    for g, r, (rtol, atol) in zip(got, ref, TOL):
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol)
    assert torch.equal(got[3][..., 1], ref[3][..., 1])


def _edge_signal(kind, n, rng):
    """[n] float32: a tone, silence, a DC offset, a tone at the Nyquist bin
    (alternating ±0.4) or an impulse; all but silence with voice()-level
    noise (0.01), since a noiseless tone leaves float noise in empty mel
    bands, where the log amplifies it."""
    if kind == "zero":
        return np.zeros(n, dtype=np.float32)
    sig = 0.01 * rng.normal(size=n)
    if kind == "tone":
        sig += 0.3 * np.sin(2 * np.pi * 170.0 * np.arange(n) / 16000.0)
    elif kind == "dc":
        sig += 0.5
    elif kind == "nyquist":
        sig += 0.4 * (-1.0) ** np.arange(n)
    else:
        sig[n // 3] += 1.0
    return sig.astype(np.float32)


def _check_repeat_and_plain(got, again, ref, kind):
    for g, a, r, (rtol, atol) in zip(got, again, ref, TOL):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol)
    if kind == "zero":
        assert not got[2].any() and not ref[2].any()  # power exactly 0


@pytest.mark.parametrize("kind", ["tone", "zero", "dc", "nyquist", "impulse"])
@pytest.mark.parametrize("n_fft", [512, 1024, 2048])
def test_k1_fft_cases_match_plain_and_repeat(device, n_fft, kind):
    rng = np.random.default_rng(n_fft)
    sig = np.stack([_edge_signal(kind, 24017, rng) for _ in range(3)])
    cfg = taf.AudioFrontendConfig(n_fft=n_fft)
    x_pad, _ = taf._pad_for_frames(torch.from_numpy(sig).to(device), cfg)
    bases = taf._device_bases(cfg, device)
    before = mfcc_signal.launches
    got = mfcc_signal(x_pad, bases, n_fft, cfg.hop_length)
    again = mfcc_signal(x_pad, bases, n_fft, cfg.hop_length)
    torch.cuda.synchronize()
    assert mfcc_signal.launches == before + 2
    ref = mfcc_signal_plain(x_pad, bases, n_fft, cfg.hop_length)
    _check_repeat_and_plain(got, again, ref, kind)
    assert torch.equal(got[3][..., 1], ref[3][..., 1])


@pytest.mark.parametrize("kind", ["tone", "zero", "dc", "nyquist", "impulse"])
@pytest.mark.parametrize("n_fft", [512, 1024])
def test_k2_fft_cases_match_plain_and_repeat(device, n_fft, kind):
    rng = np.random.default_rng(n_fft)
    frames = torch.from_numpy(np.stack(
        [_edge_signal(kind, n_fft, rng) for _ in range(101)])).to(device)
    bases = taf._device_bases(taf.AudioFrontendConfig(n_fft=n_fft), device)
    before = k2.mfcc_frames.launches
    got = k2.mfcc_frames(frames, bases, n_fft)
    again = k2.mfcc_frames(frames, bases, n_fft)
    torch.cuda.synchronize()
    assert k2.mfcc_frames.launches == before + 2
    ref = k2.mfcc_frames_plain(frames, bases, n_fft)
    _check_repeat_and_plain(got, again, ref, kind)


@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_non_power_of_two_n_fft_raises_on_card(device, kernel):
    """The kernels' FFT takes a power-of-two n_fft; 768 (a multiple of the
    hop, which the dense K1 took) raises before any launch."""
    cfg = taf.AudioFrontendConfig(n_fft=768)
    bases = taf._device_bases(cfg, device)
    if kernel == "k1":
        x_pad, _ = taf._pad_for_frames(torch.zeros(1, 8000, device=device), cfg)
        before = mfcc_signal.launches
        with pytest.raises(ValueError, match="power-of-two"):
            mfcc_signal(x_pad, bases, 768, cfg.hop_length)
        assert mfcc_signal.launches == before
    else:
        before = k2.mfcc_frames.launches
        with pytest.raises(ValueError, match="n_fft"):
            k2.mfcc_frames(torch.zeros(4, 768, device=device), bases, 768)
        assert k2.mfcc_frames.launches == before


def test_features_default_to_kernel_on_cuda(device):
    sig = torch.randn(2, 20000, device=device)
    before = mfcc_signal.launches
    feats = taf.extract_utterance_features_batch(sig)
    assert mfcc_signal.launches == before + 1
    plain = taf.extract_utterance_features_batch(sig, plain=True)
    torch.testing.assert_close(feats, plain, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_fft,rows", [(512, 37), (1024, 4096), (1024, 597)])
def test_k2_matches_plain(device, n_fft, rows):
    """Rows not a multiple of the kernel's 8-row block included."""
    rng = np.random.default_rng(rows)
    frames = torch.from_numpy(
        rng.normal(size=(rows, n_fft)).astype(np.float32)).to(device)
    bases = taf._device_bases(taf.AudioFrontendConfig(n_fft=n_fft), device)
    before = k2.mfcc_frames.launches
    got = k2.mfcc_frames(frames, bases, n_fft)
    torch.cuda.synchronize()
    assert k2.mfcc_frames.launches == before + 1
    ref = k2.mfcc_frames_plain(frames, bases, n_fft)
    for g, r, (rtol, atol) in zip(got, ref, TOL):
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol)


def test_stream_tick_launches_k2_once(device):
    """One push of 4 streams is one K2 launch, eager and replayed from the
    tick's graph, and matches plain=True."""
    model = create_complete_deer_model(seed=0, device=device)
    recs = [tstream.StreamingRecognizer(model, n_streams=4, device=device,
                                        plain=plain, graphs=graphs)
            for plain, graphs in ((False, False), (True, False), (False, True))]
    chunks = np.random.default_rng(0).normal(size=(4, 4096)).astype(np.float32)
    before = k2.mfcc_frames.launches
    got = recs[0].push(chunks)
    assert k2.mfcc_frames.launches == before + 1
    ref = recs[1].push(chunks)
    assert k2.mfcc_frames.launches == before + 1
    recs[2].warmup()  # K2's wrapper runs at the warm-up and the capture
    captured = k2.mfcc_frames.launches
    assert captured > before + 1
    graphed = recs[2].push(chunks)  # the replay launches K2 without it
    assert k2.mfcc_frames.launches == captured
    for out in (got, graphed):
        for key in ref:
            np.testing.assert_allclose(out[key], ref[key], rtol=1e-4,
                                       atol=1e-5, err_msg=key)


def _k3_case(device, b, h, tq, tk, d, seed=0, kind="prefix"):
    """(q, k, v, mask, dO) on the card; element 0 gets a padding mask
    ("prefix"), a hole of whole 64-key tiles between valid keys ("hole"),
    valid keys in its last 64-key tile only ("last_tile"), or in its first
    tile and past its first 32 tiles ("far", where K3b reads a second
    window of live tiles); the last element is all-masked."""
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(b, h, tq, d, generator=g) for _ in range(2))
    k, v = (torch.randn(b, h, tk, d, generator=g) for _ in range(2))
    mask = torch.ones(b, tk)
    if kind == "prefix":
        mask[0, tk // 3:] = 0.0
    elif kind == "hole":
        mask[0, 64:192] = 0.0
    elif kind == "last_tile":
        mask[0, :(tk - 1) // 64 * 64] = 0.0
    else:
        mask[0] = 0.0
        mask[0, 10:20] = 1.0
        mask[0, 2100:2150] = 1.0
    mask[-1] = 0.0  # an all-masked element
    return [x.to(device) for x in (q, k, v, mask, do)]


@pytest.mark.parametrize("b,h,tq,tk,d", [(2, 4, 100, 100, 32),
                                         (3, 2, 130, 300, 64),
                                         (2, 2, 77, 45, 32)])
def test_k3_matches_plain(device, b, h, tq, tk, d):
    """Each kernel against its plain twin, and the autograd function
    against the plain function's autograd gradients; ragged T, Tq != Tk,
    an all-masked element."""
    _check_k3(*_k3_case(device, b, h, tq, tk, d))


@pytest.mark.parametrize("kind", ["hole", "last_tile", "far"])
@pytest.mark.parametrize("d", [32, 64])
def test_k3_skipped_tiles_match_plain(device, kind, d):
    """Masks whose masked keys fill whole key tiles, which K3b and K3c
    skip: a hole between valid keys, a Tk of a few hundred with only its
    last tile live, and live tiles on both sides of the 32-tile window
    K3b reads at a time; the all-masked element beside them."""
    tk = 2200 if kind == "far" else 300
    _check_k3(*_k3_case(device, 3, 2, 130, tk, d, kind=kind))


def _check_k3(q, k, v, mask, do):
    tol = dict(rtol=1e-4, atol=2e-5)
    counts = lambda: (k3.flash_attention_fwd.launches,
                      k3.flash_attention_bwd_dq.launches,
                      k3.flash_attention_bwd_dkv.launches)
    before = counts()
    o, lse = k3.flash_attention_fwd(q, k, v, mask)
    delta, dq = k3.flash_attention_bwd_dq(q, k, v, mask, o, do, lse)
    dk, dv = k3.flash_attention_bwd_dkv(q, k, v, mask, do, lse, delta)
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in before)
    ro, rlse = k3.flash_attention_fwd_plain(q, k, v, mask)
    rdelta, rdq = k3.flash_attention_bwd_dq_plain(q, k, v, mask, o, do, lse)
    rdk, rdv = k3.flash_attention_bwd_dkv_plain(q, k, v, mask, do, lse, delta)
    for got, ref in ((o, ro), (lse, rlse), (delta, rdelta), (dq, rdq),
                     (dk, rdk), (dv, rdv)):
        torch.testing.assert_close(got, ref, **tol)
    assert not dq[-1].any() and not dk[-1].any()

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    (k3.flash_attention(*leaves, mask) * do).sum().backward()
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    (k3.flash_attention_plain(*plain, mask) * do).sum().backward()
    for a, b_ in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b_.grad, **tol)
    assert counts() == tuple(c + 2 for c in before)


@pytest.mark.parametrize("kind", ["prefix", "hole", "last_tile", "far"])
@pytest.mark.parametrize("b,h,tq,tk,d", [(2, 4, 100, 100, 32),
                                         (3, 2, 130, 300, 64),
                                         (2, 2, 77, 45, 32)])
def test_k3a_repeats_and_all_masked_is_mean_of_v(device, b, h, tq, tk, d, kind):
    """K3a twice on the same inputs gives the same bits (no atomics, a
    fixed order); the all-masked element gets O = the mean of v over its Tk
    keys and an lse that the backward reads as "no valid key"."""
    if kind == "far":
        tk = 2200
    q, k, v, mask, _ = _k3_case(device, b, h, tq, tk, d, kind=kind)
    o, lse = k3.flash_attention_fwd(q, k, v, mask)
    o2, lse2 = k3.flash_attention_fwd(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    torch.testing.assert_close(o[-1], v[-1].mean(1, keepdim=True).expand_as(o[-1]),
                               rtol=1e-4, atol=2e-5)
    assert (lse[-1] < k3.NO_VALID_KEY).all() and (lse[:-1] > k3.NO_VALID_KEY).all()


def _emb_case(device, kind):
    """(ids, dX, V) on the card: 131,072 ids of which ~99% are PAD_ID with
    D = 128 (the raw trainer's padded transcripts at the CLI's width), a
    6-id vocabulary with every id repeated at D = 24, or a wide table (D =
    200, two column groups) with an id never used."""
    g = torch.Generator().manual_seed(len(kind))
    if kind == "padding":
        ids = torch.full((64, 2048), PAD_ID, dtype=torch.int64)
        real = torch.randint(4, 17, (64,), generator=g)
        for row, n in zip(ids, real):
            row[:n] = torch.randint(1, 300, (int(n),), generator=g)
        v, d = 300, 128
    elif kind == "repeats":
        v, d = 6, 24
        ids = torch.randint(0, v, (5, 777), generator=g)
    else:
        v, d = 1000, 200
        ids = torch.randint(0, v - 1, (3, 500), generator=g)
    dx = torch.randn(*ids.shape, d, generator=g)
    return ids.to(device), dx.to(device), v


@pytest.mark.parametrize("kind", ["padding", "repeats", "wide"])
def test_embedding_grad_matches_plain_and_repeats(device, kind):
    ids, dx, v = _emb_case(device, kind)
    before = emb.embedding_grad.launches
    got = emb.embedding_grad(ids, dx, v)
    again = emb.embedding_grad(ids, dx, v)
    torch.cuda.synchronize()
    assert emb.embedding_grad.launches == before + 2
    assert torch.equal(got, again)
    ref = emb.embedding_grad_plain(ids, dx.double(), v)
    torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-3)
    unused = torch.ones(v, dtype=torch.bool, device=device)
    unused[ids.reshape(-1)] = False
    assert not got[unused].any()


def test_embedding_lookup_on_card(device):
    """The autograd function: one gradient launch a backward, the plain
    function's values and gradient; a frozen table launches none."""
    ids, dx, v = _emb_case(device, "repeats")
    weight = torch.randn(v, dx.shape[-1], device=device)
    w = weight.clone().requires_grad_()
    wp = weight.clone().requires_grad_()
    before = emb.embedding_grad.launches
    out = emb.embedding_lookup(ids, w)
    (out * dx).sum().backward()
    assert emb.embedding_grad.launches == before + 1
    ref = emb.embedding_lookup_plain(ids, wp)
    (ref * dx).sum().backward()
    assert emb.embedding_grad.launches == before + 1
    assert torch.equal(out, ref)
    torch.testing.assert_close(w.grad, wp.grad, rtol=1e-5, atol=1e-4)
    scale = torch.ones((), device=device, requires_grad=True)
    (emb.embedding_lookup(ids, weight) * scale).sum().backward()
    assert emb.embedding_grad.launches == before + 1 and scale.grad is not None


@pytest.mark.parametrize("bad", ["d48", "non_contiguous", "float16"])
def test_k3_wrapper_raises(device, bad):
    q, k, v, mask, _ = _k3_case(device, 1, 2, 64, 64, 48 if bad == "d48" else 32)
    if bad == "non_contiguous":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "float16":
        q, k, v = q.half(), k.half(), v.half()
    before = k3.flash_attention_fwd.launches
    with pytest.raises((TypeError, ValueError)):
        k3.flash_attention(q, k, v, mask)
    assert k3.flash_attention_fwd.launches == before


def _k4_case(device, case, g):
    """(w, bits) on the card for a K4 case: a shape, or a named edge."""
    if isinstance(case, tuple):
        w = torch.randn(case, generator=g)
    elif case in ("below_capacity", "above_capacity"):
        # Just under and over the largest w staged whole: above it, each
        # share rounds its last group from L2 (the chunked path).
        cap = k4.staged_capacity(device)
        w = torch.randn(cap - 1 if case == "below_capacity" else cap + 3,
                        generator=g)
    elif case == "not_multiple_of_4":
        w = torch.randn(2**20 + 3, generator=g)  # 64 shares, a ragged end
    elif case == "misaligned":
        w = torch.randn(2**20 + 6, generator=g)[1:]  # 4 bytes past 16
    elif case == "zeros":
        w = torch.zeros(1000, 1000)
    elif case == "subnormals":
        w = torch.randn(300, 301, generator=g)
        w.view(-1)[1::2] *= 1e-39  # beside normals: quotients below FLT_MIN
    else:  # "huge_among_small": quotients around FLT_MIN
        w = torch.randn(512, 513, generator=g) * 1e-10
        w[100, 7] = 1e30
    w = w.to(device)
    bits = torch.randint(-2**31, 2**31 - 1, w.shape, dtype=torch.int32,
                         generator=g).to(device)
    if case == "misaligned":
        bits = torch.randint(-2**31, 2**31 - 1, (w.numel() + 1,),
                             dtype=torch.int32, generator=g).to(device)[1:]
    return w, bits


def test_k4_refused_cooperative_launch_raises(device, monkeypatch):
    """A grid larger than the card holds at once is refused by the
    cooperative launch; the wrapper raises and counts no launch."""
    resident, stage_bytes = k4.launch_config(device.index)
    monkeypatch.setattr(k4, "launch_config",
                        lambda card: (2 * resident, stage_bytes))
    w = torch.ones(2 * resident * k4.MIN_SHARE, device=device)
    before = k4.quantize_int8_stochastic.launches
    with pytest.raises(RuntimeError, match="quantize_int8 launch failed"):
        k4.quantize_int8_stochastic(w)
    assert k4.quantize_int8_stochastic.launches == before


@pytest.mark.parametrize("shape", [
    (1, 1), (7, 13), (768, 512), (1001,), "below_capacity", "above_capacity",
    "not_multiple_of_4", "misaligned", "zeros", "subnormals",
    "huge_among_small"])
def test_k4_matches_plain(device, shape):
    """Both modes: the given words (bits) and Philox keyed by a 64-bit seed,
    against the plain twins, values and scale bits, and each again bit for
    bit; a misaligned view takes the scalar path; w just below and above
    the card's staged capacity (read from the wrapper); zeros, subnormals
    and one 1e30 among small values."""
    g = torch.Generator().manual_seed(
        len(shape) if isinstance(shape, tuple) else sum(map(ord, shape)))
    w, bits = _k4_case(device, shape, g)
    before = (k4.quantize_int8_stochastic.launches,
              k4.quantize_int8_stochastic_bits.launches)
    got = [k4.quantize_int8_stochastic_bits(w, bits),
           k4.quantize_int8_stochastic(w, seed=2**40 + 3)]
    torch.cuda.synchronize()
    assert (k4.quantize_int8_stochastic.launches,
            k4.quantize_int8_stochastic_bits.launches) == (before[0] + 1,
                                                           before[1] + 1)
    refs = [k4.quantize_int8_stochastic_bits_plain(w, bits),
            k4.quantize_int8_stochastic_plain(w, seed=2**40 + 3)]
    again = [k4.quantize_int8_stochastic_bits(w, bits),
             k4.quantize_int8_stochastic(w, seed=2**40 + 3)]
    for (q, s), (rq, rs), (aq, as_) in zip(got, refs, again):
        assert q.shape == w.shape and s.shape == (1, 1)
        assert torch.equal(q, rq)
        assert torch.equal(s.view(torch.int32), rs.view(torch.int32))
        assert torch.equal(aq, q)
        assert torch.equal(as_.view(torch.int32), s.view(torch.int32))
    if isinstance(shape, tuple) and len(shape) == 1:
        view = w[1:]  # 4 bytes past a 16-byte boundary
        q, s = k4.quantize_int8_stochastic(view, seed=5)
        rq, rs = k4.quantize_int8_stochastic_plain(view, seed=5)
        assert torch.equal(q, rq) and torch.equal(s, rs)


def test_enhanced_features_on_card_match_plain(device):
    """The enhanced 84-d vectors of voiced utterances through K1 (one
    launch for the batch) against the plain twin's on the card, within
    rtol 1e-4, atol 1e-5; the conv route's products (cuDNN's convolution)
    against the plain twin's within the front-end tolerances."""
    rng = np.random.default_rng(14)
    n = 32000
    t = np.arange(n) / 16000.0
    sig = np.stack([0.3 * np.sin(2 * np.pi * (120 + 40 * i) * t)
                    + 0.02 * rng.normal(size=n) for i in range(4)])
    x = torch.from_numpy(sig.astype(np.float32)).to(device)
    before = mfcc_signal.launches
    got = taf.extract_enhanced_utterance_features(x)
    assert mfcc_signal.launches - before == 1
    ref = taf.extract_enhanced_utterance_features(x, plain=True)
    assert got.shape == (4, 84) and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    before = mfcc_signal.launches
    conv = taf.mfcc_from_signal(x, path="conv")
    assert mfcc_signal.launches == before
    for g, r, (rtol, atol) in zip(conv, taf.mfcc_from_signal(x, plain=True), TOL):
        torch.testing.assert_close(g, r, rtol=rtol, atol=atol)


def test_unified_encoder_text_takes_k3a_at_2048(device):
    """UnifiedSequenceEncoder's text encoder at 2,048 tokens in eval
    launches K3a once a layer and matches use_flash=False."""
    from tpu_deer_torch.models.encoders import UnifiedSequenceEncoder
    from tpu_deer_torch.models.layers import init_flax_style_

    enc = UnifiedSequenceEncoder(modalities=("text",))
    init_flax_style_(enc, torch.Generator().manual_seed(0))
    enc = enc.to(device).eval()
    ids = torch.randint(1, 30522, (2, 2048), device=device)
    mask = torch.ones(2, 2048, device=device)
    mask[1, 700:] = 0
    before = k3.flash_attention_fwd.launches
    with torch.no_grad():
        got = enc(token_ids=ids, text_mask=mask)
        assert k3.flash_attention_fwd.launches - before == len(enc.text.blocks)
        for block in enc.text.blocks:
            block.attn.use_flash = False
        ref = enc(token_ids=ids, text_mask=mask)
    for key in ref:
        torch.testing.assert_close(got[key], ref[key], rtol=1e-4, atol=5e-5)


def test_remat_graphed_fused_step_equals_eager(device):
    """remat=True with dropout on: the fused steps replayed from their CUDA
    graph (the recomputation reading the step's seed from the registered
    second generator state) equal eager per-step updates from the same
    state in every bit."""
    from tpu_deer_torch.data.pipeline import ArrayDataset, BatchIterator
    from tpu_deer_torch.data.synthetic import SyntheticConfig, make_synthetic_splits
    from tpu_deer_torch.models.deer_model import DEERModelConfig
    from tpu_deer_torch.train.trainer import DEERTrainer, TrainingConfig

    width = dict(encoder_dim=64, fusion_dim=128, encoder_layers=1, dropout=0.3)
    rows = make_synthetic_splits(SyntheticConfig(n_train=64 * 6, n_val=8,
                                                 n_test=8, seed=11))["train"]
    iters = {"synthetic": BatchIterator(ArrayDataset(rows, "synthetic"), 64,
                                        shuffle=True, drop_last=True, seed=7)}

    def trainer(fused):
        cfg = TrainingConfig(batch_size=64, num_epochs=2, remat=True, seed=7,
                             fused_epochs=fused, dataset_weights={"synthetic": 1.0})
        return DEERTrainer(create_complete_deer_model(DEERModelConfig(**width),
                                                      seed=3, device=device),
                           cfg, steps_per_epoch=6, device=device)

    graphed = trainer(True)
    graphed.train_epoch(iters, 0)  # warm-up steps, capture, replays
    eager = trainer(False)
    eager.load_state_dict(graphed.state_dict())
    replays = graphed.graph_replays
    graphed.train_epoch(iters, 1)
    eager.train_epoch(iters, 1)
    assert graphed.graph_replays - replays == 6
    for name, v in graphed.params.items():
        assert torch.equal(v, eager.params[name]), name
