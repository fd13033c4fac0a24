"""Visualization suite — matplotlib on host, headless-safe.

Port of `tpu_deer/viz/report.py`: the same plots drawn from the same
arrays, computed by the port's numpy metrics. matplotlib is imported only
where a static figure is drawn (`_pyplot`); where it is not installed,
`create_comprehensive_report` still writes the interactive HTML dashboard
and the JSON data export (numpy only), records `"static": "matplotlib is
not installed"` among its paths and logs a warning.

Parity with reference `src/utils/visualization.py` (same plot families):
  * EmotionSpaceVisualizer   — visualization.py:59-255 (VA scatter, 3D VAD,
    temporal trajectories)
  * UncertaintyVisualizer    — visualization.py:258-460 (decomposition,
    calibration/reliability, uncertainty-vs-error)
  * AttentionVisualizer      — visualization.py:463-584 (modality attention
    heatmaps and statistics)
  * PerformanceVisualizer    — visualization.py:587-783 (training curves,
    model comparison)
  * create_comprehensive_report — visualization.py:1019-1198 (all plots +
    summary into an output dir)

The reference's plotly "InteractiveVisualizer" (visualization.py:786-1016) is
covered by viz.html_report — a self-contained interactive HTML dashboard
(drag-rotatable 3D emotion space, hover tooltips, light/dark) with zero
external dependencies — written alongside the static plots and the JSON
data export.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

DIMS = ("valence", "arousal", "dominance")
NO_MATPLOTLIB = "matplotlib is not installed"


def _pyplot():
    """matplotlib.pyplot on the headless Agg backend (ImportError where
    matplotlib is not installed)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    _pyplot().close(fig)
    return path


class EmotionSpaceVisualizer:
    def plot_valence_arousal_space(
        self, predictions, targets, uncertainties=None, save_path="va_space.png"
    ):
        plt = _pyplot()
        fig, axes = plt.subplots(1, 2, figsize=(12, 5))
        for ax, data, title in (
            (axes[0], targets, "Ground truth"),
            (axes[1], predictions, "Predictions"),
        ):
            c = None
            if title == "Predictions" and uncertainties is not None:
                c = np.asarray(uncertainties).mean(axis=1)
            sc = ax.scatter(
                data[:, 0], data[:, 1], c=c,
                cmap="viridis" if c is not None else None, s=12, alpha=0.6,
            )
            if c is not None:
                fig.colorbar(sc, ax=ax, label="uncertainty")
            ax.set_xlabel("valence")
            ax.set_ylabel("arousal")
            ax.set_title(title)
            ax.set_xlim(-1.1, 1.1)
            ax.set_ylim(-1.1, 1.1)
            ax.grid(alpha=0.3)
        return _save(fig, save_path)

    def plot_3d_emotion_space(self, predictions, targets, save_path="vad_3d.png"):
        plt = _pyplot()
        fig = plt.figure(figsize=(7, 6))
        ax = fig.add_subplot(111, projection="3d")
        ax.scatter(*targets[:, :3].T, s=10, alpha=0.4, label="truth")
        ax.scatter(*predictions[:, :3].T, s=10, alpha=0.4, label="pred")
        ax.set_xlabel("valence")
        ax.set_ylabel("arousal")
        ax.set_zlabel("dominance")
        ax.legend()
        return _save(fig, save_path)

    def plot_temporal_trajectories(
        self, trajectory, save_path="trajectories.png", labels=DIMS
    ):
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(9, 4))
        t = np.arange(len(trajectory))
        for i, name in enumerate(labels[: trajectory.shape[1]]):
            ax.plot(t, trajectory[:, i], label=name)
        ax.set_xlabel("time step")
        ax.set_ylabel("value")
        ax.legend()
        ax.grid(alpha=0.3)
        return _save(fig, save_path)


class UncertaintyVisualizer:
    def plot_uncertainty_decomposition(
        self, aleatoric, epistemic, save_path="uncertainty_decomposition.png"
    ):
        plt = _pyplot()
        fig, axes = plt.subplots(1, 3, figsize=(14, 4))
        aleatoric = np.asarray(aleatoric)
        epistemic = np.asarray(epistemic)
        for i, name in enumerate(DIMS[: aleatoric.shape[1]]):
            axes[i].hist(aleatoric[:, i], bins=30, alpha=0.6, label="aleatoric")
            axes[i].hist(epistemic[:, i], bins=30, alpha=0.6, label="epistemic")
            axes[i].set_title(name)
            axes[i].legend()
        return _save(fig, save_path)

    def plot_uncertainty_calibration(
        self, reliability: dict, save_path="calibration.png"
    ):
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(5, 5))
        conf = reliability["bin_confidence"]
        acc = reliability["bin_accuracy"]
        ax.plot([0, 1], [0, 1], "k--", label="perfect")
        ax.plot(conf, acc, "o-", label="model")
        ax.set_xlabel("confidence")
        ax.set_ylabel("accuracy")
        ax.legend()
        ax.grid(alpha=0.3)
        return _save(fig, save_path)

    def plot_uncertainty_vs_error(
        self, errors, uncertainties, save_path="uncertainty_vs_error.png"
    ):
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(6, 5))
        e = np.asarray(errors).ravel()
        u = np.asarray(uncertainties).ravel()
        ax.scatter(u, e, s=8, alpha=0.4)
        # trend line
        if len(e) > 2:
            coef = np.polyfit(u, e, 1)
            xs = np.linspace(u.min(), u.max(), 50)
            ax.plot(xs, np.polyval(coef, xs), "r-", label=f"slope={coef[0]:.3f}")
            ax.legend()
        ax.set_xlabel("predicted uncertainty")
        ax.set_ylabel("|error|")
        ax.grid(alpha=0.3)
        return _save(fig, save_path)

    def plot_sparsification(self, spars: dict, save_path="sparsification.png"):
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(6, 5))
        ax.plot(spars["fractions"], spars["sparsification"], label="by uncertainty")
        ax.plot(spars["fractions"], spars["oracle"], "--", label="oracle")
        ax.set_xlabel("fraction removed")
        ax.set_ylabel("mean error of kept samples")
        ax.set_title(f"AUSE = {spars['ause']:.4f}")
        ax.legend()
        ax.grid(alpha=0.3)
        return _save(fig, save_path)


class AttentionVisualizer:
    def plot_attention_heatmap(
        self, attention_weights, save_path="attention_heatmap.png",
        modalities=("audio", "video", "text"),
    ):
        plt = _pyplot()
        w = np.asarray(attention_weights)
        fig, ax = plt.subplots(figsize=(7, 4))
        im = ax.imshow(w[:50].T, aspect="auto", cmap="viridis")
        ax.set_yticks(range(len(modalities)))
        ax.set_yticklabels(modalities)
        ax.set_xlabel("sample")
        fig.colorbar(im, ax=ax, label="attention weight")
        return _save(fig, save_path)

    def plot_attention_statistics(
        self, attention_weights, save_path="attention_stats.png",
        modalities=("audio", "video", "text"),
    ):
        plt = _pyplot()
        w = np.asarray(attention_weights)
        fig, ax = plt.subplots(figsize=(6, 4))
        means = w.mean(axis=0)
        stds = w.std(axis=0)
        ax.bar(modalities[: w.shape[1]], means, yerr=stds, capsize=4)
        ax.set_ylabel("mean attention weight")
        ax.grid(axis="y", alpha=0.3)
        return _save(fig, save_path)


class PerformanceVisualizer:
    def plot_training_curves(self, history: dict, save_path="training_curves.png"):
        plt = _pyplot()
        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        axes[0].plot(history.get("train_loss", []), label="train")
        if history.get("val_loss"):
            axes[0].plot(history["val_loss"], label="val")
        axes[0].set_title("loss")
        axes[0].legend()
        if history.get("val_ccc"):
            axes[1].plot(history["val_ccc"])
        axes[1].set_title("val CCC (avg)")
        if history.get("learning_rate"):
            axes[2].plot(history["learning_rate"])
        axes[2].set_title("learning rate")
        for ax in axes:
            ax.grid(alpha=0.3)
            ax.set_xlabel("epoch")
        return _save(fig, save_path)

    def plot_model_comparison(
        self, results: dict[str, dict], metric="ccc_average",
        save_path="model_comparison.png",
    ):
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(6, 4))
        names = list(results.keys())
        vals = [results[n].get(metric, 0.0) for n in names]
        ax.bar(names, vals)
        ax.set_ylabel(metric)
        ax.grid(axis="y", alpha=0.3)
        return _save(fig, save_path)

    def plot_per_dimension_metrics(
        self, metrics: dict, save_path="per_dim_metrics.png"
    ):
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(7, 4))
        cccs = [metrics.get(f"ccc_{d}", 0.0) for d in DIMS]
        maes = [metrics.get(f"mae_{d}", 0.0) for d in DIMS]
        x = np.arange(len(DIMS))
        ax.bar(x - 0.2, cccs, width=0.4, label="CCC")
        ax.bar(x + 0.2, maes, width=0.4, label="MAE")
        ax.set_xticks(x)
        ax.set_xticklabels(DIMS)
        ax.legend()
        ax.grid(axis="y", alpha=0.3)
        return _save(fig, save_path)


def plot_summary_figure(
    predictions: np.ndarray,
    targets: np.ndarray,
    uncertainties: Optional[np.ndarray] = None,
    history: Optional[dict] = None,
    save_path: str = "summary.png",
) -> str:
    """One combined figure with the headline panels: VA space, training
    curves, reliability, uncertainty-vs-error, per-dim CCC, uncertainty
    histogram — the at-a-glance summary the per-plot report lacked."""
    plt = _pyplot()
    from tpu_deer_torch.core.metrics import ccc_np

    predictions = np.asarray(predictions)
    targets = np.asarray(targets)
    fig, axes = plt.subplots(2, 3, figsize=(16, 9))

    # (0,0) VA space, predictions colored by uncertainty.
    ax = axes[0, 0]
    c = np.asarray(uncertainties).mean(axis=1) if uncertainties is not None else None
    sc = ax.scatter(predictions[:, 0], predictions[:, 1], c=c, cmap="viridis",
                    s=10, alpha=0.6)
    if c is not None:
        fig.colorbar(sc, ax=ax, label="uncertainty")
    ax.set_xlabel("valence"); ax.set_ylabel("arousal")
    ax.set_title("Predicted emotion space")
    ax.set_xlim(-1.1, 1.1); ax.set_ylim(-1.1, 1.1); ax.grid(alpha=0.3)

    # (0,1) training loss; (0,2) validation CCC — two single-axis panels
    # (never a dual-axis chart).
    ax = axes[0, 1]
    if history and history.get("train_loss"):
        ax.plot(history["train_loss"])
        ax.set_xlabel("epoch"); ax.set_ylabel("loss")
        ax.set_title("Training loss"); ax.grid(alpha=0.3)
    else:
        ax.axis("off")
    ax = axes[0, 2]
    if history and history.get("val_ccc"):
        ax.plot(history["val_ccc"], color="tab:green")
        ax.set_xlabel("validation epoch"); ax.set_ylabel("CCC")
        ax.set_title("Validation CCC"); ax.grid(alpha=0.3)
    else:
        ax.axis("off")

    if uncertainties is not None:
        unc = np.asarray(uncertainties).mean(axis=1)
        err = np.abs(predictions - targets).mean(axis=1)
        # (1,0) reliability — the ece_np definition (uncertainty-quantile
        # bins, conf = 1-u, acc = 1-|err|), so the plotted ECE matches the
        # reported headline metric. (CalibrationAnalyzer keeps the
        # reference's threshold-accuracy definition for the parity eval
        # path, but its curve is not a meaningful calibration picture.)
        from tpu_deer_torch.core.metrics import reliability_np

        ax = axes[1, 0]
        rel = reliability_np(predictions, targets, uncertainties)
        ax.plot([0, 1], [0, 1], "--", color="gray", label="ideal")
        ax.plot(rel["bin_confidence"], rel["bin_accuracy"], "o-", label="observed")
        ax.set_xlabel("confidence (1 − uncertainty)")
        ax.set_ylabel("accuracy (1 − |error|)")
        ax.set_title(f"Reliability (ECE {rel['ece']:.3f})")
        ax.legend(); ax.grid(alpha=0.3)
        # (1,1) uncertainty vs error.
        ax = axes[1, 1]
        ax.scatter(unc, err, s=8, alpha=0.5)
        r = np.corrcoef(unc, err)[0, 1] if len(unc) > 1 else 0.0
        ax.set_xlabel("uncertainty"); ax.set_ylabel("|error|")
        ax.set_title(f"Uncertainty vs error (r={r:.3f})")
        ax.grid(alpha=0.3)
    else:
        axes[1, 0].axis("off")
        axes[1, 1].axis("off")

    # (1,2) per-dim CCC bars.
    ax = axes[1, 2]
    cccs = [ccc_np(targets[:, i], predictions[:, i])
            for i in range(predictions.shape[1])]
    names = list(DIMS[: predictions.shape[1]])
    ax.bar(names, cccs, width=0.5)
    for i, v in enumerate(cccs):
        ax.text(i, v + 0.01, f"{v:.3f}", ha="center", fontsize=9)
    ax.set_ylim(0, max(1.0, max(cccs) + 0.1))
    ax.set_title("CCC per dimension"); ax.grid(alpha=0.3, axis="y")

    fig.suptitle("Multimodal DEER — summary", fontsize=14)
    fig.tight_layout(rect=(0, 0, 1, 0.97))
    return _save(fig, save_path)


def create_comprehensive_report(
    predictions: np.ndarray,
    targets: np.ndarray,
    uncertainties: Optional[np.ndarray] = None,
    attention_weights: Optional[np.ndarray] = None,
    history: Optional[dict] = None,
    aleatoric: Optional[np.ndarray] = None,
    epistemic: Optional[np.ndarray] = None,
    output_dir: str = "report",
) -> dict[str, str]:
    """Generate the full plot set + a JSON data export. Returns {name: path}.

    Parity with visualization.py:1019-1198. Without matplotlib: the
    interactive dashboard and the JSON data export only, with
    `"static": NO_MATPLOTLIB` among the paths.
    """
    from tpu_deer_torch.core.metrics import evaluate_predictions

    os.makedirs(output_dir, exist_ok=True)
    paths: dict[str, str] = {}
    p = lambda name: os.path.join(output_dir, name)
    metrics = evaluate_predictions(predictions, targets, uncertainties)
    try:
        _pyplot()
    except ImportError:
        logger.warning("%s: writing the interactive report and the JSON "
                       "data export without the static plots", NO_MATPLOTLIB)
        paths["static"] = NO_MATPLOTLIB
    else:
        _static_plots(predictions, targets, uncertainties, attention_weights,
                      history, aleatoric, epistemic, metrics, p, paths)

    if uncertainties is not None:
        # Interactive dashboard (reference InteractiveVisualizer capability,
        # visualization.py:786-1016) — self-contained HTML, no plotly.
        from tpu_deer_torch.viz.html_report import create_interactive_report

        paths["interactive"] = create_interactive_report(
            predictions, targets, uncertainties, history,
            p("interactive_report.html"),
        )

    with open(p("report_data.json"), "w") as f:
        json.dump({"metrics": metrics, "plots": paths}, f, indent=2)
    paths["report_data"] = p("report_data.json")
    return paths


def _static_plots(predictions, targets, uncertainties, attention_weights,
                  history, aleatoric, epistemic, metrics, p, paths) -> None:
    """create_comprehensive_report's matplotlib figures, in the reference's
    order."""
    from tpu_deer_torch.eval.uncertainty import sparsification_curve

    emo = EmotionSpaceVisualizer()
    paths["va_space"] = emo.plot_valence_arousal_space(
        predictions, targets, uncertainties, p("va_space.png")
    )
    if predictions.shape[1] >= 3:
        paths["vad_3d"] = emo.plot_3d_emotion_space(
            predictions, targets, p("vad_3d.png")
        )

    if uncertainties is not None:
        from tpu_deer_torch.core.metrics import reliability_np

        uv = UncertaintyVisualizer()
        errors = np.abs(predictions - targets)
        # Quantile-binned reliability (the ece_np definition) so the plotted
        # curve matches the reported ECE; see plot_summary_figure.
        paths["calibration"] = uv.plot_uncertainty_calibration(
            reliability_np(predictions, targets, uncertainties),
            p("calibration.png"),
        )
        paths["uncertainty_vs_error"] = uv.plot_uncertainty_vs_error(
            errors.mean(axis=1), np.asarray(uncertainties).mean(axis=1),
            p("uncertainty_vs_error.png"),
        )
        spars = sparsification_curve(
            errors.mean(axis=1), np.asarray(uncertainties).mean(axis=1)
        )
        paths["sparsification"] = uv.plot_sparsification(
            spars, p("sparsification.png")
        )
        if aleatoric is not None and epistemic is not None:
            paths["decomposition"] = uv.plot_uncertainty_decomposition(
                aleatoric, epistemic, p("uncertainty_decomposition.png")
            )

    if attention_weights is not None:
        av = AttentionVisualizer()
        paths["attention_heatmap"] = av.plot_attention_heatmap(
            attention_weights, p("attention_heatmap.png")
        )
        paths["attention_stats"] = av.plot_attention_statistics(
            attention_weights, p("attention_stats.png")
        )

    perf = PerformanceVisualizer()
    if history is not None:
        paths["training_curves"] = perf.plot_training_curves(
            history, p("training_curves.png")
        )
    paths["per_dim_metrics"] = perf.plot_per_dimension_metrics(
        metrics, p("per_dim_metrics.png")
    )
    paths["summary"] = plot_summary_figure(
        predictions, targets, uncertainties, history, p("summary.png")
    )
