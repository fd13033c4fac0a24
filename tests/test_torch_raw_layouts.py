"""The port's raw corpora in the RAVDESS and MELD layouts, the joint-corpus
helpers and `cli --raw --raw_dataset` against the JAX package on the CPU.

The fixtures written from one seed are equal file for file, byte for byte
(the same numpy draws, wav writer and CSV writer); the loaders' arrays and
vocabularies are equal exactly (numpy on both sides, own copies);
`merge_vocabs` and `combine_raw_splits` exactly. `cli --raw` runs the port
end to end on the CPU in each layout at the quick width for one epoch and
writes the reference's `raw_results.json` keys.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from tpu_deer.data import raw_corpus as jrc
from tpu_deer_torch import cli as tcli
from tpu_deer_torch.data import raw_corpus as trc

torch.set_num_threads(1)

SMALL = dict(duration_s=0.3, n_frames=2, image_size=8, seed=3)
GENERATORS = {
    "ravdess": (lambda m, root: m.generate_raw_fixture_ravdess(
        root, n_per_actor=2, **SMALL), jrc.load_raw_ravdess, trc.load_raw_ravdess),
    "meld": (lambda m, root: m.generate_raw_fixture_meld(
        root, n_train=12, n_val=4, n_test=4, **SMALL), jrc.load_raw_meld,
        trc.load_raw_meld),
    "iemocap": (lambda m, root: m.generate_raw_fixture(
        root, n_train=12, n_val=4, n_test=4, **SMALL), jrc.load_raw_corpus,
        trc.load_raw_corpus),
}
LOAD = dict(max_audio_s=0.5, max_video_frames=2, image_size=8, max_tokens=12)


def _files(root):
    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """{layout: (reference root, port root)} written from one seed."""
    out = {}
    for layout, (gen, _, _) in GENERATORS.items():
        roots = [str(tmp_path_factory.mktemp(f"{layout}_{side}"))
                 for side in ("jax", "port")]
        gen(jrc, roots[0])
        gen(trc, roots[1])
        out[layout] = roots
    return out


@pytest.mark.parametrize("layout", ["ravdess", "meld"])
def test_fixture_is_bit_identical(layout, corpora):
    ref, got = (_files(r) for r in corpora[layout])
    assert sorted(got) == sorted(ref) and len(ref) > 40
    for name in ref:
        assert got[name] == ref[name], name


@pytest.mark.parametrize("layout", sorted(GENERATORS))
def test_loader_matches_jax(layout, corpora):
    _, jload, tload = GENERATORS[layout]
    ref, ref_vocab = jload(corpora[layout][0], **LOAD)
    got, vocab = tload(corpora[layout][1], **LOAD)
    assert vocab.itos == ref_vocab.itos and vocab.max_length == ref_vocab.max_length
    assert list(got) == list(ref)
    for split in ref:
        assert set(got[split]) == set(ref[split])
        for k, r in ref[split].items():
            assert got[split][k].dtype == r.dtype, (split, k)
            np.testing.assert_array_equal(got[split][k], r, err_msg=f"{split} {k}")
    # Loaded again under another corpus's vocabulary: the given one is used.
    shared, _ = tload(corpora[layout][1], vocab=vocab, **LOAD)
    np.testing.assert_array_equal(shared["train"]["token_ids"],
                                  got["train"]["token_ids"])


def test_joint_corpus_matches_jax(corpora):
    """merge_vocabs over the RAVDESS and MELD vocabularies, both corpora
    loaded again under it, and combine_raw_splits with its dataset_id."""
    loaded = {}
    for side, rc in enumerate((jrc, trc)):
        vocabs = [GENERATORS[n][1 + side](corpora[n][side], **LOAD)[1]
                  for n in ("ravdess", "meld")]
        merged = rc.merge_vocabs(vocabs, max_length=LOAD["max_tokens"])
        splits = {n: GENERATORS[n][1 + side](corpora[n][side], vocab=merged,
                                             **LOAD)[0]
                  for n in ("ravdess", "meld")}
        loaded[side] = (merged, rc.combine_raw_splits(splits))
    (jv, ref), (tv, got) = loaded[0], loaded[1]
    assert tv.itos == jv.itos
    assert list(got) == list(ref)
    for split in ref:
        assert set(got[split]) == set(ref[split]) and "dataset_id" in got[split]
        for k in ref[split]:
            np.testing.assert_array_equal(got[split][k], ref[split][k])
    ids = got["train"]["dataset_id"]
    assert set(np.unique(ids)) == {0, 1} and np.all(np.diff(ids) >= 0)


def test_meld_missing_media_is_zero_filled(corpora, tmp_path, caplog):
    root = tmp_path / "meld"
    root.mkdir()
    for name in ("train_sent_emo.csv", "dev_sent_emo.csv", "test_sent_emo.csv"):
        src = os.path.join(corpora["meld"][1], name)
        (root / name).write_text(open(src).read())
    with caplog.at_level(logging.WARNING):
        got, _ = trc.load_raw_meld(str(root), **LOAD)
    ref, _ = jrc.load_raw_meld(str(root), **LOAD)
    assert "zero-filled" in caplog.text
    for split in ref:
        assert not got[split]["signal"].any() and not got[split]["video_frames"].any()
        np.testing.assert_array_equal(got[split]["token_ids"], ref[split]["token_ids"])


REFERENCE_KEYS = {"experiment_dir", "raw_layout", "raw_root", "vocab_size",
                  "best_val_ccc", "test", "history", "training_time_s"}


@pytest.mark.parametrize("layout", ["iemocap", "ravdess", "meld"])
def test_cli_raw_dataset(layout, tmp_path):
    """`cli --raw --raw_dataset` in each layout on the CPU: the fixture the
    reference would generate (seed 42, quick sizes), one epoch at the quick
    width, the reference's summary keys, finite metrics."""
    out = tmp_path / "out"
    assert tcli.main(["--raw", "--raw_dataset", layout, "--quick", "--epochs",
                      "1", "--output_dir", str(out), "--experiment_name", "r",
                      "--platform", "cpu"]) == 0
    with open(out / "r" / "results" / "raw_results.json") as f:
        summary = json.load(f)
    assert set(summary) == REFERENCE_KEYS and summary["raw_layout"] == layout
    assert len(summary["history"]["train_loss"]) == 1
    assert np.isfinite(summary["test"]["ccc_average"])
    root = summary["raw_root"]
    ref_root = str(tmp_path / "ref_fixture")
    n = (96, 24, 24)
    if layout == "ravdess":
        jrc.generate_raw_fixture_ravdess(ref_root, n_per_actor=round(n[0] / 18),
                                         seed=42)
    elif layout == "meld":
        jrc.generate_raw_fixture_meld(ref_root, *n, seed=42)
    else:
        jrc.generate_raw_fixture(ref_root, *n, seed=42)
    assert _files(root) == _files(ref_root)
    _, jload, _ = GENERATORS[layout]
    assert summary["vocab_size"] == jload(ref_root)[1].vocab_size
