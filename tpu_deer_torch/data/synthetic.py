"""Seeded synthetic multimodal dataset — the dataset-free quick-mode fixture.

Own copy of `tpu_deer/data/synthetic.py`: the same seed gives bit-identical
arrays. The VAD labels are a deterministic nonlinear function of the
features plus controllable noise, so training curves and CCC measure
learning; a feature-dependent fraction of samples carries extra label noise,
so uncertainty has real signal to learn.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    n_train: int = 1000
    n_val: int = 200
    n_test: int = 200
    audio_dim: int = 84
    video_dim: int = 256
    text_dim: int = 768
    emotion_dims: int = 3
    label_noise: float = 0.05
    # Per-sample difficulty heterogeneity: fraction of samples with extra
    # label noise, so uncertainty estimation has real signal to learn.
    hard_fraction: float = 0.3
    hard_noise: float = 0.4
    # Whether hardness is a FUNCTION OF THE FEATURES (a fixed audio-feature
    # projection above its quantile) or independent coin flips. Independent
    # hardness is unlearnable by construction — no model can rank
    # uncertainty by a label the features don't carry — which capped
    # uncertainty-error correlation at ~0.5 (the tanh-squash side signal)
    # in round-1 results. Feature-dependent hardness makes the benchmark
    # actually test uncertainty learning.
    hard_from_features: bool = True
    # Shared cross-modal latent: when set, every modality's features are a
    # mixing of `latent_dim` per-sample latent factors plus independent
    # noise, so the inputs carry the within-modality correlations and
    # cross-modal coupling real multimodal data has (the premise fusion
    # models exist for). With the default (None) the features are i.i.d.
    # N(0,1) — which makes structure-breaking OOD probes (column shuffling,
    # modality misalignment) DISTRIBUTIONALLY VACUOUS: permuting i.i.d.
    # columns is a measure-preserving map, so no detector can or should fire
    # on them. experiments/ood_study.py uses latent_dim to make those probes
    # genuine distribution shifts.
    latent_dim: int | None = None
    # Fraction of each feature's variance carried by the latent (the rest is
    # independent noise). Marginals stay ~N(0,1) either way.
    latent_strength: float = 0.7
    # Benchmark v2 (requires latent_dim): labels are a function of the LATENT
    # z rather than of dense feature projections, and each modality observes
    # only a subset of latent dims (audio ~58%, video ~42%, text ~83%, with a
    # shared core carrying the hardness signal). Consequences, by design:
    #   * every single modality has a meaningful, BOUNDED ceiling — for a
    #     modality seeing fraction v of the label variance the best CCC is
    #     ~2v/(1+v) (A≈0.74, V≈0.59, T≈0.91), so a video-only model scores
    #     well above 0 (the round-2 ablation's v1 video column was 0.053
    #     because dense projections over 256 dims are sample-starved);
    #   * modalities are complementary, so fusion is genuinely required to
    #     reach the full ceiling (mirrors the reference's claimed ablation
    #     shape, README.md:407-415);
    #   * hardness lives on the shared core dims, so uncertainty is
    #     learnable from ANY modality subset (v1 tied it to audio features
    #     only, making V/T-only uncertainty unlearnable by construction).
    # v1 (default False) is kept bit-identical for existing tests/artifacts.
    labels_from_latent: bool = False
    seed: int = 42
    # Seed for the label-generating projections; defaults to `seed`. Give two
    # configs the same label_seed (and different seeds) to create distinct
    # datasets that share a label function — the cross-dataset-transfer
    # fixture.
    label_seed: int | None = None


def visible_latent_dims(latent_dim: int) -> dict[str, np.ndarray]:
    """Canonical per-modality latent visibility masks for benchmark v2.

    Audio sees ~58% of the latent dims, video ~42%, text ~83%; the first
    ~1/6 ("core") dims are visible to every modality and carry the hardness
    signal. The union always covers the full latent, so trimodal fusion can
    reach the full label ceiling while each single modality is bounded.
    """
    L = int(latent_dim)
    core = max(1, L // 6)
    n_a = max(core, round(0.58 * L))
    n_v = max(core, round(0.42 * L))
    n_t = max(core, round(0.83 * L))
    audio = np.arange(0, min(n_a, L))
    video = np.unique(
        np.concatenate([np.arange(core), np.arange(n_a, min(n_a + n_v - core, L))])
    )
    text = np.unique(
        np.concatenate([np.arange(core), np.arange(max(0, L - (n_t - core)), L)])
    )
    # Cover any dims the three windows missed (tiny L edge cases) via text.
    covered = np.unique(np.concatenate([audio, video, text]))
    missing = np.setdiff1d(np.arange(L), covered)
    if missing.size:
        text = np.unique(np.concatenate([text, missing]))
    return {"audio": audio, "video": video, "text": text, "core": np.arange(core)}


def _make_split(cfg: SyntheticConfig, n: int, rng: np.random.Generator) -> dict:
    # Fixed random projections (drawn from a seed-derived generator so every
    # split shares the same label function).
    label_seed = cfg.label_seed if cfg.label_seed is not None else cfg.seed
    proj_rng = np.random.default_rng(label_seed + 7919)

    if cfg.labels_from_latent:
        if not cfg.latent_dim:
            raise ValueError("labels_from_latent requires latent_dim")
        return _make_split_v2(cfg, n, rng, proj_rng)

    if cfg.latent_dim:
        # x_m = sqrt(s)·z A_m + sqrt(1-s)·eps with unit-norm mixing columns:
        # each feature keeps an ~N(0,1) marginal, but features within a
        # modality are correlated through z and modalities are coupled by
        # sharing it. The mixing matrices come from proj_rng so every split
        # (and any config sharing label_seed) lives on the same manifold.
        z = rng.standard_normal((n, cfg.latent_dim))
        s = float(np.clip(cfg.latent_strength, 0.0, 1.0))

        def mix(dim: int) -> np.ndarray:
            a = proj_rng.standard_normal((cfg.latent_dim, dim))
            a /= np.linalg.norm(a, axis=0, keepdims=True)
            return np.sqrt(s) * (z @ a) + np.sqrt(1.0 - s) * rng.standard_normal(
                (n, dim)
            )

        audio = mix(cfg.audio_dim).astype(np.float32)
        video = mix(cfg.video_dim).astype(np.float32)
        text = mix(cfg.text_dim).astype(np.float32)
    else:
        audio = rng.standard_normal((n, cfg.audio_dim)).astype(np.float32)
        video = rng.standard_normal((n, cfg.video_dim)).astype(np.float32)
        text = rng.standard_normal((n, cfg.text_dim)).astype(np.float32)
    w_a = proj_rng.standard_normal((cfg.audio_dim, cfg.emotion_dims)) / np.sqrt(
        cfg.audio_dim
    )
    w_v = proj_rng.standard_normal((cfg.video_dim, cfg.emotion_dims)) / np.sqrt(
        cfg.video_dim
    )
    w_t = proj_rng.standard_normal((cfg.text_dim, cfg.emotion_dims)) / np.sqrt(
        cfg.text_dim
    )
    w2 = proj_rng.standard_normal((cfg.emotion_dims, cfg.emotion_dims))

    base = audio @ w_a + video @ w_v + text @ w_t
    signal = np.tanh(base + 0.5 * np.tanh(base @ w2))

    if cfg.hard_from_features and cfg.hard_fraction > 0:
        # Hardness carried by the features: a fixed projection of the audio
        # features above its (1 - hard_fraction) quantile. The quantile is a
        # distributional constant (standard normal projection), so splits
        # share the same decision rule.
        w_h = proj_rng.standard_normal(cfg.audio_dim) / np.sqrt(cfg.audio_dim)
        hard_score = audio @ w_h
        from scipy.stats import norm

        thresh = norm.ppf(1.0 - cfg.hard_fraction)
        is_hard = hard_score > thresh
    else:
        is_hard = rng.random(n) < cfg.hard_fraction
    noise_scale = np.where(is_hard, cfg.hard_noise, cfg.label_noise)
    labels = np.tanh(
        signal + noise_scale[:, None] * rng.standard_normal((n, cfg.emotion_dims))
    ).astype(np.float32)

    return {
        "audio": audio,
        "video": video,
        "text": text,
        "labels": labels,
        "is_hard": is_hard.astype(np.float32),
    }


def _make_split_v2(
    cfg: SyntheticConfig,
    n: int,
    rng: np.random.Generator,
    proj_rng: np.random.Generator,
) -> dict:
    """Benchmark v2: latent-structured labels with per-modality partial
    observability (see the `labels_from_latent` config comment)."""
    L = int(cfg.latent_dim)
    vis = visible_latent_dims(L)
    z = rng.standard_normal((n, L))
    s = float(np.clip(cfg.latent_strength, 0.0, 1.0))

    def observe(dims: np.ndarray, out_dim: int) -> np.ndarray:
        a = proj_rng.standard_normal((len(dims), out_dim))
        a /= np.linalg.norm(a, axis=0, keepdims=True)
        x = np.sqrt(s) * (z[:, dims] @ a)
        return (x + np.sqrt(1.0 - s) * rng.standard_normal((n, out_dim))).astype(
            np.float32
        )

    audio = observe(vis["audio"], cfg.audio_dim)
    video = observe(vis["video"], cfg.video_dim)
    text = observe(vis["text"], cfg.text_dim)

    w = proj_rng.standard_normal((L, cfg.emotion_dims)) / np.sqrt(L)
    w2 = proj_rng.standard_normal((cfg.emotion_dims, cfg.emotion_dims))
    base = z @ w
    signal = np.tanh(base + 0.5 * np.tanh(base @ w2))

    if cfg.hard_fraction > 0:
        # Hardness lives on the core dims every modality observes, so the
        # uncertainty target is learnable from any modality subset.
        core = vis["core"]
        w_h = proj_rng.standard_normal(len(core))
        # Unit norm, not 1/sqrt(len): with few core dims a lucky/unlucky draw
        # would otherwise move the score's std far from 1 and break the
        # quantile threshold (observed: ||w_h|| = 0.10 -> zero hard samples).
        w_h /= np.linalg.norm(w_h)
        hard_score = z[:, core] @ w_h
        from scipy.stats import norm

        is_hard = hard_score > norm.ppf(1.0 - cfg.hard_fraction)
    else:
        is_hard = np.zeros(n, dtype=bool)
    noise_scale = np.where(is_hard, cfg.hard_noise, cfg.label_noise)
    labels = np.tanh(
        signal + noise_scale[:, None] * rng.standard_normal((n, cfg.emotion_dims))
    ).astype(np.float32)

    return {
        "audio": audio,
        "video": video,
        "text": text,
        "labels": labels,
        "is_hard": is_hard.astype(np.float32),
        # Generative ground truth, for oracle/data-ceiling rows in studies
        # (never fed to models — the trainer only consumes the keys above).
        "signal": signal.astype(np.float32),
        "noise_scale": noise_scale.astype(np.float32),
    }


def benchmark_v2(
    n_train: int,
    n_val: int | None = None,
    n_test: int | None = None,
    seed: int = 42,
    **overrides,
) -> SyntheticConfig:
    """The canonical latent-structured benchmark config used by the round-3+
    studies (ablation / fusion / ensemble). 24 latent dims, strength 0.75,
    30% hard samples at noise 0.4 vs 0.05 easy."""
    return SyntheticConfig(
        n_train=n_train,
        n_val=n_val if n_val is not None else max(n_train // 8, 128),
        n_test=n_test if n_test is not None else max(n_train // 8, 128),
        latent_dim=24,
        latent_strength=0.75,
        labels_from_latent=True,
        seed=seed,
        **overrides,
    )


def make_synthetic_splits(cfg: SyntheticConfig | None = None) -> dict[str, dict]:
    """Returns {"train": {...}, "val": {...}, "test": {...}} numpy dicts."""
    cfg = cfg or SyntheticConfig()
    rng = np.random.default_rng(cfg.seed)
    return {
        "train": _make_split(cfg, cfg.n_train, rng),
        "val": _make_split(cfg, cfg.n_val, rng),
        "test": _make_split(cfg, cfg.n_test, rng),
    }
