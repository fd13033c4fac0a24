"""F0 fidelity, through the port: the front-end's autocorrelation F0 on
the card against a pyin-style reference, both scored against synthesized
signals whose pitch is known exactly.

    python -m tpu_deer_torch.experiments.f0_fidelity
    python -m tpu_deer_torch.experiments.f0_fidelity --quick --platform cpu

Twin of `experiments/f0_fidelity.py`, with its flags, cases, scores and
payload keys. The cases (flat tones at 110-440 Hz, a 90-480 Hz log sweep,
5% vibrato, a speech-like log-f0 walk, voiced/unvoiced alternation and a
220 Hz tone at 20, 10 and 0 dB SNR) and the pyin-style reference (YIN's
cumulative-mean-normalized difference, a Beta(2, 18) threshold ensemble and
Viterbi over a log-pitch grid; Mauch & Dixon 2014) are the reference's
numpy, copied here. The estimator is the port's
`ops/audio_frontend.py:f0_autocorrelation` on the power spectrum of
`frame_signal`'s frames from kernel K2 (`kernels/mfcc_frames.py`, one
launch a case at n_fft 1,024; its plain twin on the CPU), the counterpart
of the reference's `_power_spectrum_xla` on frames. Scores: VDE (voicing
decision error), GPE (both-voiced frames more than 20% off) and the mean
error in cents on the rest, for both estimators, and their agreement in
cents where both say voiced.

Differences from the reference: the estimator runs on the card (the
reference forces its CPU), `--platform cpu` on the CPU; results go to
`results_torch/RESULTS_f0_h100.{json,md}` (`--quick`: three cases,
`..._quick`), the payload adds `platform` (the card's name and power
limit), and the table sets the reference's autocorrelation GPE and VDE
beside each case's.
"""

from __future__ import annotations

import numpy as np

from tpu_deer_torch.experiments import twin

SR = 16000
QUICK_CASES = ("flat 220Hz", "sweep 90-480Hz", "voiced/unvoiced alt")


# ---------------------------------------------------------------------------
# Synthesis with exact ground truth
# ---------------------------------------------------------------------------
def synth_voiced(f0: np.ndarray, sr: int = SR, n_harmonics: int = 12,
                 seed: int = 0, snr_db: float | None = None) -> np.ndarray:
    """Harmonic complex (1/k amplitudes — glottal-ish spectrum) following an
    instantaneous per-sample f0 contour, optional white noise at snr_db."""
    rng = np.random.default_rng(seed)
    phase = 2.0 * np.pi * np.cumsum(f0) / sr
    sig = np.zeros_like(f0)
    for k in range(1, n_harmonics + 1):
        # Zero out harmonics that would alias above Nyquist anywhere.
        if (k * f0).max() < sr / 2:
            sig += np.sin(k * phase + rng.uniform(0, 2 * np.pi)) / k
    sig /= np.abs(sig).max() + 1e-9
    if snr_db is not None:
        noise = rng.normal(size=sig.shape)
        noise *= np.sqrt((sig**2).mean() / (noise**2).mean()) * 10 ** (
            -snr_db / 20.0
        )
        sig = sig + noise
    return sig.astype(np.float32)


def make_cases(hop: int) -> dict[str, dict]:
    """Name → {signal, f0 (per sample), voiced (per sample)} test battery."""
    t2 = np.arange(2 * SR)
    cases = {}

    def add(name, f0_samples, voiced=None, **kw):
        f0_samples = np.asarray(f0_samples, np.float64)
        v = np.ones_like(f0_samples, bool) if voiced is None else voiced
        sig = synth_voiced(np.where(v, f0_samples, 0.0), **kw)
        if not v.all():  # unvoiced stretches: white noise at speech level
            rng = np.random.default_rng(99)
            sig = np.where(v, sig, 0.3 * rng.normal(size=len(sig)))
        cases[name] = {
            "signal": sig.astype(np.float32),
            "f0": f0_samples,
            "voiced": v,
        }

    for hz in (110.0, 220.0, 330.0, 440.0):
        add(f"flat {hz:.0f}Hz", np.full(SR, hz), seed=int(hz))
    # Log sweep spanning most of the configured range.
    add("sweep 90-480Hz", 90.0 * (480.0 / 90.0) ** (t2 / len(t2)), seed=1)
    add(
        "vibrato 220Hz±5%",
        220.0 * (1 + 0.05 * np.sin(2 * np.pi * 5.5 * t2 / SR)),
        seed=2,
    )
    # Speech-like: smoothed log-f0 random walk in 100–300 Hz.
    rng = np.random.default_rng(3)
    walk = np.cumsum(rng.normal(0, 0.012, size=len(t2) // hop))
    walk = np.interp(np.arange(len(t2)), np.arange(len(walk)) * hop, walk)
    k = np.ones(2048) / 2048
    walk = np.convolve(walk, k, mode="same")
    add("speech-like walk", np.clip(170.0 * np.exp(walk), 100, 300), seed=3)
    # Voiced/unvoiced alternation (0.4 s voiced, 0.25 s unvoiced).
    v = np.zeros(2 * SR, bool)
    period = int(0.65 * SR)
    for start in range(0, 2 * SR, period):
        v[start : start + int(0.4 * SR)] = True
    add("voiced/unvoiced alt", np.full(2 * SR, 180.0), voiced=v, seed=4)
    # Noise robustness.
    for snr in (20.0, 10.0, 0.0):
        add(f"220Hz @ {snr:.0f}dB SNR", np.full(SR, 220.0), seed=5, snr_db=snr)
    return cases


# ---------------------------------------------------------------------------
# pyin-style host reference (Mauch & Dixon 2014), vectorized numpy
# ---------------------------------------------------------------------------
def yin_cmndf(frames: np.ndarray, max_lag: int) -> np.ndarray:
    """Cumulative-mean-normalized difference function per frame.

    frames [F, N] → d' [F, max_lag]; d'[,0] = 1 by definition.
    Difference via Wiener-Khinchin: d(tau) = e_head + e_tail - 2 acf(tau).
    """
    F, N = frames.shape
    spec = np.fft.rfft(frames, 2 * N, axis=-1)
    acf = np.fft.irfft(spec * np.conj(spec), axis=-1)[:, :max_lag]
    sq = frames**2
    csum = np.concatenate(
        [np.zeros((F, 1)), np.cumsum(sq, axis=-1)], axis=-1
    )  # [F, N+1]
    taus = np.arange(max_lag)
    e_head = csum[:, N - taus] - csum[:, [0]]  # sum x_j^2, j<N-tau
    e_tail = csum[:, [N]] - csum[:, taus]  # sum x_j^2, j>=tau
    d = np.maximum(e_head + e_tail - 2.0 * acf, 0.0)
    dsum = np.cumsum(d[:, 1:], axis=-1)
    cmndf = np.ones_like(d)
    cmndf[:, 1:] = d[:, 1:] * taus[1:] / np.maximum(dsum, 1e-12)
    return cmndf


def _parabolic_refine(cmndf: np.ndarray, tau: np.ndarray) -> np.ndarray:
    """Sub-sample minimum location around integer lag tau (per frame)."""
    F = cmndf.shape[0]
    t = np.clip(tau, 1, cmndf.shape[1] - 2)
    rows = np.arange(F)
    a, b, c = cmndf[rows, t - 1], cmndf[rows, t], cmndf[rows, t + 1]
    denom = a - 2 * b + c
    shift = np.where(np.abs(denom) > 1e-12, 0.5 * (a - c) / np.maximum(
        np.abs(denom), 1e-12) * np.sign(denom + (denom == 0)), 0.0)
    return t + np.clip(shift, -0.5, 0.5)


def pyin(
    signal: np.ndarray,
    sr: int = SR,
    frame_length: int = 1024,
    hop: int = 256,
    fmin: float = 65.0,
    fmax: float = 520.0,
    n_thresholds: int = 100,
    n_bins_per_semitone: int = 5,
    switch_prob: float = 0.01,
    max_semitones_per_frame: float = 12.0,
) -> tuple[np.ndarray, np.ndarray]:
    """pyin-style F0: YIN CMNDF + Beta(2,18) threshold ensemble + Viterbi
    over a log-pitch grid with voiced/unvoiced states.

    Returns (f0 [F], voiced [F]) at the same centered frame positions as
    ops.audio_frontend.frame_signal (reflect padding, hop-spaced centers).
    """
    pad = frame_length // 2
    x = np.pad(signal.astype(np.float64), (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - frame_length) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame_length)[None, :]
    frames = x[idx]
    min_lag = max(2, int(sr / fmax))
    max_lag = min(int(sr / fmin) + 1, frame_length - 1)
    cmndf = yin_cmndf(frames, max_lag + 1)

    # Beta(2,18) prior over thresholds (librosa's default parameters).
    thresholds = np.linspace(0, 1, n_thresholds + 1)[1:]
    a_beta, b_beta = 2.0, 18.0
    tgrid = np.linspace(1e-6, 1 - 1e-6, n_thresholds)
    pdf = tgrid ** (a_beta - 1) * (1 - tgrid) ** (b_beta - 1)
    beta_w = pdf / pdf.sum()

    # Candidate = for each threshold, the FIRST local minimum of CMNDF below
    # it within [min_lag, max_lag] (YIN's absolute-threshold step).
    F = cmndf.shape[0]
    lags = np.arange(max_lag + 1)
    interior = cmndf[:, 1:-1]
    is_min = (interior <= cmndf[:, :-2]) & (interior <= cmndf[:, 2:])
    is_min = np.pad(is_min, ((0, 0), (1, 1)))
    is_min &= (lags >= min_lag) & (lags <= max_lag)

    # Pitch grid (log-spaced bins).
    n_bins = int(np.ceil(12 * n_bins_per_semitone * np.log2(fmax / fmin))) + 1
    bin_freqs = fmin * 2 ** (np.arange(n_bins) / (12 * n_bins_per_semitone))
    obs = np.zeros((F, n_bins + 1))  # last column = unvoiced state

    big = np.where(is_min, cmndf, np.inf)
    order = np.argsort(big, axis=1)  # minima first, by depth
    for fi in range(F):
        cand_lags = [l for l in order[fi] if np.isfinite(big[fi, l])]
        if not cand_lags:
            obs[fi, -1] = 1.0
            continue
        cand_lags = np.array(cand_lags)
        cand_vals = cmndf[fi, cand_lags]
        # For each threshold: first candidate (in lag order) below it.
        lag_sorted = np.sort(cand_lags)
        val_sorted = cmndf[fi, lag_sorted]
        below = val_sorted[None, :] < thresholds[:, None]  # [T, C]
        first = np.argmax(below, axis=1)
        any_below = below.any(axis=1)
        # Voiced mass: thresholds that found a candidate; unvoiced otherwise.
        for ti in range(n_thresholds):
            if any_below[ti]:
                lag = lag_sorted[first[ti]]
                rt = _parabolic_refine(cmndf[fi : fi + 1], np.array([lag]))[0]
                fhz = sr / max(rt, 1e-6)
                if fmin <= fhz <= fmax:
                    b = np.clip(
                        np.round(
                            12 * n_bins_per_semitone * np.log2(fhz / fmin)
                        ).astype(int),
                        0,
                        n_bins - 1,
                    )
                    obs[fi, b] += beta_w[ti]
                else:
                    obs[fi, -1] += beta_w[ti]
            else:
                # pyin: no-candidate mass goes to unvoiced, with a small
                # leak to the best minimum (librosa boltzmann leak ~ skip).
                obs[fi, -1] += beta_w[ti]
        s = obs[fi].sum()
        if s > 0:
            obs[fi] /= s
        else:
            obs[fi, -1] = 1.0

    # Viterbi over 2*n_bins states — librosa's pyin state space: bin b
    # voiced AND bin b unvoiced ("pitch memory" through unvoiced spans).
    # Both halves share the same Gaussian local-pitch transition, so the
    # spreading cost of the pitch prior is paid EQUALLY by voiced and
    # unvoiced paths. (A single collapsed unvoiced state is not equivalent:
    # it pays no spreading cost, so any per-frame unvoiced observation mass
    # over ~exp(-log n_eff) — a couple of percent — would make the unvoiced
    # path dominate and the decoder declare entire clean sweeps unvoiced.)
    max_jump = max_semitones_per_frame * n_bins_per_semitone
    dist = np.abs(np.arange(n_bins)[:, None] - np.arange(n_bins)[None, :])
    with np.errstate(divide="ignore"):
        logA = np.where(
            dist <= max_jump, -0.5 * (dist / (0.4 * max_jump)) ** 2, -np.inf
        )
    logA = logA - np.log(np.exp(logA).sum(axis=1, keepdims=True))
    log_stay = np.log1p(-switch_prob)
    log_switch = np.log(switch_prob)

    # Observations: voiced mass per bin; unvoiced mass spread uniformly
    # over the n_bins unvoiced states (librosa pitch.py: observation_probs
    # [n_pitch_bins:, :] = (1 - voiced_prob) / n_pitch_bins).
    logobs_v = np.log(np.maximum(obs[:, :n_bins], 1e-12))
    logobs_u = np.log(np.maximum(obs[:, -1:] / n_bins, 1e-12))
    delta_v = -np.log(2 * n_bins) + logobs_v[0]
    delta_u = -np.log(2 * n_bins) + logobs_u[0] * np.ones(n_bins)
    back = np.zeros((F, 2 * n_bins), np.int32)
    for fi in range(1, F):
        # Best predecessor under the shared pitch transition, per half.
        cand_v = delta_v[None, :] + logA  # [to, from]
        cand_u = delta_u[None, :] + logA
        best_v = cand_v.argmax(axis=1)
        best_u = cand_u.argmax(axis=1)
        m_v = cand_v[np.arange(n_bins), best_v]
        m_u = cand_u[np.arange(n_bins), best_u]
        # → voiced bin: from voiced (stay) or unvoiced (switch).
        from_u = m_u + log_switch > m_v + log_stay
        delta_v_new = np.where(from_u, m_u + log_switch, m_v + log_stay)
        back[fi, :n_bins] = np.where(from_u, best_u + n_bins, best_v)
        # → unvoiced bin: from unvoiced (stay) or voiced (switch).
        from_v = m_v + log_switch > m_u + log_stay
        delta_u_new = np.where(from_v, m_v + log_switch, m_u + log_stay)
        back[fi, n_bins:] = np.where(from_v, best_v, best_u + n_bins)
        delta_v = delta_v_new + logobs_v[fi]
        delta_u = delta_u_new + logobs_u[fi]
    delta = np.concatenate([delta_v, delta_u])
    states = np.empty(F, np.int32)
    states[-1] = int(delta.argmax())
    for fi in range(F - 1, 0, -1):
        states[fi - 1] = back[fi, states[fi]]
    voiced = states < n_bins
    f0 = np.where(voiced, bin_freqs[states % n_bins], 0.0)
    return f0, voiced


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------
def frame_truth(case: dict, hop: int, n_frames: int):
    centers = np.minimum(np.arange(n_frames) * hop, len(case["f0"]) - 1)
    return case["f0"][centers], case["voiced"][centers]


def score(f0_est, voiced_est, f0_true, voiced_true) -> dict:
    n = len(f0_true)
    vde = float((voiced_est != voiced_true).mean())
    both = voiced_est & voiced_true
    if both.sum() == 0:
        return {"vde": vde, "gpe": 1.0, "mae_cents": float("nan"),
                "n_frames": n, "n_both_voiced": 0}
    rel = np.abs(f0_est[both] - f0_true[both]) / f0_true[both]
    gpe = float((rel > 0.2).mean())
    fine = rel <= 0.2
    cents = 1200 * np.abs(np.log2(f0_est[both][fine] / f0_true[both][fine]))
    return {
        "vde": vde,
        "gpe": gpe,
        "mae_cents": float(cents.mean()) if fine.any() else float("nan"),
        "n_frames": n,
        "n_both_voiced": int(both.sum()),
    }


def autocorr_f0(signal: np.ndarray, device, route: str = "frames"):
    """(f0, voiced) per frame of `signal` from the port's front-end on
    `device`: the power of `frame_signal`'s frames from K2 (route
    "frames"), or the power K1 computes from the signal (route "signal")."""
    import torch

    from tpu_deer_torch.ops.audio_frontend import (
        AudioFrontendConfig,
        f0_autocorrelation,
        frame_signal,
        mfcc_frames,
        mfcc_from_signal,
    )

    cfg = AudioFrontendConfig()
    x = torch.from_numpy(np.ascontiguousarray(signal, np.float32)).to(device)
    if route == "frames":
        power = mfcc_frames(frame_signal(x, cfg), cfg)[2]
    else:
        power = mfcc_from_signal(x, cfg)[2]
    f0, voiced = f0_autocorrelation(power, cfg)
    return f0.cpu().numpy(), voiced.cpu().numpy()


def run_study(quick: bool = False, device=None) -> dict:
    """Every case (`quick`: QUICK_CASES) through `autocorr_f0` on `device`
    (None is the card) and the pyin-style reference, each scored against
    the synthesis's truth."""
    from tpu_deer_torch.device import resolve_device
    from tpu_deer_torch.ops.audio_frontend import AudioFrontendConfig

    device = resolve_device(device)
    cfg = AudioFrontendConfig()
    cases = make_cases(cfg.hop_length)
    if quick:
        cases = {k: cases[k] for k in QUICK_CASES}
    rows = []
    for name, case in cases.items():
        f0_ac, v_ac = autocorr_f0(case["signal"], device)
        f0_py, v_py = pyin(case["signal"], SR, cfg.n_fft, cfg.hop_length,
                           cfg.f0_min, cfg.f0_max)
        f0_t, v_t = frame_truth(case, cfg.hop_length, len(f0_ac))
        row = {"case": name, "autocorr": score(f0_ac, v_ac, f0_t, v_t),
               "pyin": score(f0_py, v_py, f0_t, v_t)}
        both = v_ac & v_py
        row["agreement_mae_cents"] = (
            float((1200 * np.abs(np.log2(f0_ac[both] / f0_py[both]))).mean())
            if both.any() else float("nan"))
        rows.append(row)
        print(f"{name:>22}: autocorr GPE {row['autocorr']['gpe']:.3f} MAE "
              f"{row['autocorr']['mae_cents']:.1f}c VDE "
              f"{row['autocorr']['vde']:.3f} | pyin GPE {row['pyin']['gpe']:.3f}"
              f" | agree {row['agreement_mae_cents']:.1f}c", flush=True)
    return {"rows": rows, "config": {
        "sr": SR, "n_fft": cfg.n_fft, "hop": cfg.hop_length,
        "f0_range": [cfg.f0_min, cfg.f0_max]}}


def main(argv=None) -> int:
    p = twin.parser(__doc__, "f0")
    args = p.parse_args(argv)
    device, platform = twin.setup(args, "f0")
    res = run_study(quick=args.quick, device=device)
    payload = {"platform": platform, **res}
    ref = {r["case"]: r for r in (twin.reference("f0") or {}).get("rows", [])}
    md = [
        "# F0 fidelity — the port's autocorrelation F0 vs a pyin-style reference",
        "",
        f"- platform: **{platform}**; the power spectrum from kernel K2 "
        "(`kernels/mfcc_frames.py`) at n_fft 1,024 on the frames, F0 by "
        "`ops/audio_frontend.py:f0_autocorrelation`; pyin on the host (numpy)",
        "- GPE = gross pitch error (>20% off, both-voiced frames); MAE in "
        "cents on the remaining frames; VDE = voicing decision error; agree = "
        "autocorr-vs-pyin MAE in cents where both say voiced; ref = the "
        "reference's committed autocorrelation scores "
        "(`experiments/RESULTS_f0.json`)",
        "",
        "| case | AC GPE | AC MAE¢ | AC VDE | ref AC GPE | ref AC VDE | pyin GPE "
        "| pyin MAE¢ | pyin VDE | agree¢ |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in res["rows"]:
        a, p_, rr = r["autocorr"], r["pyin"], ref.get(r["case"], {}).get("autocorr")
        refs = (f"{rr['gpe']:.3f} | {rr['vde']:.3f}" if rr else "— | —")
        md.append(f"| {r['case']} | {a['gpe']:.3f} | {a['mae_cents']:.1f} | "
                  f"{a['vde']:.3f} | {refs} | {p_['gpe']:.3f} | "
                  f"{p_['mae_cents']:.1f} | {p_['vde']:.3f} | "
                  f"{r['agreement_mae_cents']:.1f} |")
    clean = [r for r in res["rows"] if "SNR" not in r["case"]]
    if clean:
        md += ["", f"Clean cases: autocorrelation GPE ≤ "
               f"{max(r['autocorr']['gpe'] for r in clean):.3f}, MAE ≤ "
               f"{max(r['autocorr']['mae_cents'] for r in clean):.1f} cents."]
    md += ["", "Reproduce: `python -m tpu_deer_torch.experiments.f0_fidelity` "
           "on the card (`--quick --platform cpu` for a CPU smoke)."]
    twin.write(args.out, md, payload)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
