"""The port's corpus loaders (IEMOCAP, RAVDESS, MELD), feature cache,
registry and loader factory against the JAX package on the CPU.

The fixtures are those of tests/test_datasets.py (real-format wavs,
EmoEvaluation and transcription files, filename-coded RAVDESS wavs, MELD
CSVs). With a caller's extractor on both sides every array is equal,
except the 84-d audio vectors: the port's go through K1's plain twin, the
reference's through its `use_pallas=False` front-end (set in its features
module for the test), within rtol 1e-4 (tests/test_torch_audio_frontend.py's
bound for utterance vectors) and atol 2e-4: these fixtures are pure tones
of 0.5 s zero-padded to the 2 s bucket, so three quarters of the frames are
silence, and the reference's own two paths (`path="conv"` and "frames")
give vectors up to 4.6e-5 apart on them; the port's are up to 8.7e-5 from
the frames path. The MLM bootstrap
(AUTO) draws other masks than the reference's, so it is held by what it
resolves and caches, at a small TextPretrainConfig. The port's cache
directory is its own, so a cache the reference wrote is never read.
"""

import functools
import os
import shutil

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from tpu_deer.data import features as jfeat
from tpu_deer.data import iemocap as jiem
from tpu_deer.data import loaders as jloaders
from tpu_deer.data import meld as jmeld
from tpu_deer.data import ravdess as jrav
from tpu_deer.data import registry as jreg
from tpu_deer.data.tokenizer import HashTokenizer as JTokenizer
from tpu_deer.ops import audio_frontend as jaf
from tpu_deer_torch.data import cache as tcache
from tpu_deer_torch.data import iemocap as tiem
from tpu_deer_torch.data import loaders as tloaders
from tpu_deer_torch.data import meld as tmeld
from tpu_deer_torch.data import ravdess as trav
from tpu_deer_torch.data import registry as treg
from tpu_deer_torch.data.features import (
    MultimodalFeatureExtractor,
    TextFeatureExtractor,
    VideoFeatureExtractor,
)
from tpu_deer_torch.data.pipeline import ArrayDataset
from tpu_deer_torch.data.tokenizer import HashTokenizer
from tpu_deer_torch.train import text_pretrain as ttp

torch.set_num_threads(1)

SR = 16000
AUDIO_TOL = dict(rtol=1e-4, atol=2e-4)
LOADERS = {"iemocap": (jiem.load_iemocap, tiem.load_iemocap),
           "ravdess": (jrav.load_ravdess, trav.load_ravdess),
           "meld": (jmeld.load_meld, tmeld.load_meld)}


def _write_wav(path, duration=0.5, freq=220.0):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t = np.arange(int(SR * duration)) / SR
    wavfile.write(path, SR, (0.4 * np.sin(2 * np.pi * freq * t) * 32767)
                  .astype(np.int16))


def _iemocap(root, missing_wav=False):
    for session, dialog in ((1, "Ses01F_impro01"), (5, "Ses05M_impro02")):
        sdir = root / f"Session{session}"
        (sdir / "dialog" / "EmoEvaluation").mkdir(parents=True)
        (sdir / "dialog" / "transcriptions").mkdir(parents=True)
        lines, tlines = [], []
        for i, gender in enumerate("FMF"):
            utt = f"{dialog}_{gender}00{i}"
            t1, t2 = 1.0 * i, 1.0 * i + 0.8
            lines.append(f"[{t1:.4f} - {t2:.4f}]\t{utt}\tneu\t"
                         f"[{2.5 + i * 0.5:.4f}, {3.0:.4f}, {2.0:.4f}]")
            tlines.append(f"{utt} [{t1:.4f}-{t2:.4f}]: hello there friend")
            if not (missing_wav and session == 5 and i == 1):
                _write_wav(str(sdir / "sentences" / "wav" / dialog / f"{utt}.wav"),
                           freq=220.0 + 40 * i)
        (sdir / "dialog" / "EmoEvaluation" / f"{dialog}.txt").write_text(
            "\n".join(lines))
        (sdir / "dialog" / "transcriptions" / f"{dialog}.txt").write_text(
            "\n".join(tlines))
    return str(root)


def _ravdess(root):
    for actor in (1, 20, 24):
        for emotion in (3, 5):
            stem = f"03-01-{emotion:02d}-01-01-01-{actor:02d}"
            _write_wav(str(root / f"Actor_{actor:02d}" / f"{stem}.wav"),
                       duration=0.5 + 0.5 * emotion)
    return str(root)


def _meld(root):
    root.mkdir(parents=True, exist_ok=True)
    header = "Sr No.,Utterance,Speaker,Emotion,Sentiment,Dialogue_ID,Utterance_ID\n"
    rows = ['1,"I am so happy today!",Joey,joy,positive,0,0\n',
            '2,"This is terrible.",Ross,sadness,negative,0,1\n',
            '3,"Whatever.",Chandler,neutral,neutral,1,0\n',
            '4,"A word.",Monica,unknown,neutral,1,1\n']
    for name in ("train_sent_emo.csv", "dev_sent_emo.csv", "test_sent_emo.csv"):
        (root / name).write_text(header + "".join(rows))
    return str(root)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("corpora")
    return {"iemocap": _iemocap(base / "iemocap", missing_wav=True),
            "ravdess": _ravdess(base / "ravdess"),
            "meld": _meld(base / "meld")}


@pytest.fixture(scope="module")
def extractors():
    """(reference, port) caller extractors: the reference's front-end
    without Pallas, the port's on the CPU (K1's plain twin)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfeat, "extract_utterance_features", functools.partial(
            jaf.extract_utterance_features, use_pallas=False))
        ref = jfeat.MultimodalFeatureExtractor()
        yield ref, MultimodalFeatureExtractor(device="cpu")


def _assert_splits_match(got: dict, ref: dict):
    assert set(got) - {"load_s", "text_encoder", "decoder"} == set(ref)
    assert got["text_backend"] == ref["text_backend"]
    assert (got.get("text_encoder") is not None) == (got["text_backend"] == "mlm")
    for split in ("train", "val", "test"):
        if split not in ref:
            continue
        g, r = got[split].arrays, ref[split].arrays
        assert set(g) == set(r) and got[split].name == ref[split].name
        for key in r:
            assert g[key].dtype == r[key].dtype and g[key].shape == r[key].shape
            if key == "audio":
                np.testing.assert_allclose(g[key], r[key], err_msg=split,
                                           **AUDIO_TOL)
            else:
                np.testing.assert_array_equal(g[key], r[key], err_msg=f"{split} {key}")


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_matches_jax(name, roots, extractors, tmp_path):
    jload, tload = LOADERS[name]
    ref = jload(roots[name], extractor=extractors[0], cache_dir=str(tmp_path / "j"))
    got = tload(roots[name], extractor=extractors[1], cache_dir=str(tmp_path / "t"))
    _assert_splits_match(got, ref)
    assert got["text_backend"] == "hashed"
    assert all(t >= 0 for t in got["load_s"].values())
    # The wav decoder of the load (the feature-level MELD load decodes none).
    assert got["decoder"] == (None if name == "meld" else "native")
    if name == "iemocap":  # the missing wav: 1,600 zeros through the front-end
        assert np.abs(got["test"].arrays["audio"]).sum(axis=1).min() > 0
    if name == "meld":  # no clips: no audio reaches K1
        assert not got["train"].arrays["audio"].any()
    # A second load is a cache hit with the same arrays.
    again = tload(roots[name], extractor=extractors[1], cache_dir=str(tmp_path / "t"))
    assert "cache_s" in again["load_s"]
    assert again["decoder"] is None  # a cache hit decodes nothing
    _assert_splits_match(again, ref)


@pytest.fixture
def small_mlm(monkeypatch):
    monkeypatch.setattr(ttp, "TextPretrainConfig", functools.partial(
        ttp.TextPretrainConfig, model_dim=16, num_layers=1, num_heads=2,
        output_dim=16))


@pytest.mark.parametrize("name", ["iemocap", "meld"])
def test_auto_bootstrap_and_cache_keys(name, roots, extractors, tmp_path,
                                       small_mlm, monkeypatch):
    """AUTO pretrains the text featurizer on the train transcripts, keys the
    feature cache on the resolved backend and caches the encoder by corpus;
    false forces hashing; a caller's extractor is used as it is."""
    tload = LOADERS[name][1]
    cdir = str(tmp_path / "auto")
    splits = tload(roots[name], cache_dir=cdir, device="cpu")
    assert splits["text_backend"] == "mlm" and splits["load_s"]["mlm_s"] > 0
    history = splits["text_encoder"].history  # trained by this load
    assert len(history["mlm_loss"]) == len(history["steps"]) > 0
    files = sorted(os.listdir(cdir))
    assert files[0] == f"{name}_full_v3_mlmtext.npz"
    assert files[1].startswith("text_encoder_")
    assert "encoder.pt" in os.listdir(os.path.join(cdir, files[1]))
    text = splits["train"].arrays["text"][0]
    assert np.any(text[:16]) and not np.any(text[16:])  # 16-d, padded to 768

    monkeypatch.setattr(ttp, "pretrain_text_encoder", None)  # cache hits only
    again = tload(roots[name], cache_dir=cdir, device="cpu")
    assert again["text_backend"] == "mlm"
    assert again["text_encoder"].history is None  # loaded from its cache
    np.testing.assert_array_equal(again["train"].arrays["text"],
                                  splits["train"].arrays["text"])

    hashed = tload(roots[name], cache_dir=cdir, pretrain_text=False, device="cpu")
    assert hashed["text_backend"] == "hashed"
    assert f"{name}_full_v3_hashedtext.npz" in os.listdir(cdir)
    utterance = "hello there friend" if name == "iemocap" else "I am so happy today!"
    np.testing.assert_allclose(hashed["train"].arrays["text"][0],
                               TextFeatureExtractor()._hashed(utterance), rtol=1e-6)
    caller = tload(roots[name], extractor=extractors[1],
                   cache_dir=str(tmp_path / "caller"))
    assert caller["text_backend"] == "hashed"
    assert extractors[1].text.encoder is None


def test_cache_directory_is_the_ports_own(roots, extractors, tmp_path):
    """A feature cache the reference left next to a corpus (its default
    `tpu_deer_cache`, here with its labels altered) is never read: the port
    caches under `tpu_deer_torch_cache`, in the same npz format."""
    root = str(tmp_path / "ravdess")
    shutil.copytree(roots["ravdess"], root)
    ref = jrav.load_ravdess(root, extractor=extractors[0])
    jdir = os.path.join(root, "tpu_deer_cache")
    with np.load(os.path.join(jdir, "ravdess_full_v1.npz")) as z:
        tampered = {k: z[k] for k in z.files}
    tampered["labels"] = tampered["labels"] + 1.0
    np.savez_compressed(os.path.join(jdir, "ravdess_full_v1.npz"), **tampered)

    got = trav.load_ravdess(root, extractor=extractors[1])
    assert tcache.cache_dir_for(root).endswith("tpu_deer_torch_cache")
    assert os.listdir(os.path.join(root, "tpu_deer_torch_cache")) == [
        "ravdess_full_v1.npz"]
    _assert_splits_match(got, ref)
    with np.load(os.path.join(root, "tpu_deer_torch_cache", "ravdess_full_v1.npz")) as z:
        assert sorted(z.files) == sorted(tampered)


def test_registry_matches_jax_without_pretraining(roots, tmp_path):
    """`datasets.pretrain_text: false`: both registries load IEMOCAP and
    MELD (RAVDESS's path does not exist), with the same arrays and meta."""
    paths = {}
    for name in ("iemocap", "meld"):
        paths[name.upper()] = str(tmp_path / name)
        shutil.copytree(roots[name], paths[name.upper()])
    config = {"datasets": {"names": ["IEMOCAP", "MELD", "RAVDESS"],
                           "paths": {**paths, "RAVDESS": "/nonexistent"},
                           "pretrain_text": False}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfeat, "extract_utterance_features", functools.partial(
            jaf.extract_utterance_features, use_pallas=False))
        ref = jreg.load_configured_datasets(config)
    got = treg.load_configured_datasets(config, device="cpu")
    assert got["meta"]["text_backend"] == ref["meta"]["text_backend"] == {
        "iemocap": "hashed", "meld": "hashed"}
    assert set(got["meta"]["load_s"]) == {"iemocap", "meld"}
    for split in ("train", "val", "test"):
        assert set(got[split]) == set(ref[split])
        for name in ref[split]:
            _assert_splits_match(
                {split: got[split][name], "text_backend": "hashed"},
                {split: ref[split][name], "text_backend": "hashed"})
    assert treg.load_configured_datasets(
        {"datasets": {"names": [], "paths": {}}}, device="cpu") is None


def test_loader_factory_matches_jax(roots, extractors, tmp_path):
    root = str(tmp_path / "iemocap")
    shutil.copytree(roots["iemocap"], root)
    ref_ds, ref_it = jloaders.create_enhanced_dataloaders(
        root, batch_size=2, extractor=extractors[0])
    got_ds, got_it = tloaders.create_enhanced_dataloaders(
        root, batch_size=2, extractor=extractors[1], device="cpu")
    assert set(got_ds) == set(ref_ds) == {"train", "val", "test"}
    assert all(isinstance(d, ArrayDataset) for d in got_ds.values())
    for split in ref_it:
        for g, r in zip(got_it[split].epoch(0), ref_it[split].epoch(0)):
            assert set(g) == set(r)
            for k in r:
                if k == "audio":
                    np.testing.assert_allclose(g[k], r[k], **AUDIO_TOL)
                else:
                    np.testing.assert_array_equal(g[k], r[k])
    with pytest.raises(ValueError):
        tloaders.create_enhanced_dataloaders("/tmp", dataset="nope")


def test_tokenizer_and_video_decoding_match_jax(tmp_path):
    texts = ["Hello there, friend!", "", "it's 42 o'clock " * 80]
    for g, r in zip(HashTokenizer().encode_batch(texts),
                    JTokenizer().encode_batch(texts)):
        np.testing.assert_array_equal(g, r)
    bad = tmp_path / "clip.mp4"
    bad.write_bytes(b"not a video")
    for path in ("/nonexistent/video.mp4", str(bad)):
        got = VideoFeatureExtractor().extract(path)
        np.testing.assert_array_equal(got, jfeat.VideoFeatureExtractor().extract(path))
        assert got.shape == (256,) and not got.any()
