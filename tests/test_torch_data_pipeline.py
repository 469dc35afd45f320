"""The port's training data pipeline (lhrs_bot_tpu_torch.data: preprocess,
datasets, loader, native, tario, build_loader) against the JAX package on
corpora written into the test's directory.

Both packages read the same files under the same `random.seed`. The JAX
side decodes every image with PIL (its native library is not built in the
repository); the port decodes PNG itself and JPEG through its own build of
`native/lhrs_host.cc` where g++ and libjpeg are there. Token ids, labels,
index streams and PNG images must be equal; JPEG images within 1 LSB of
the PIL path, the bound of tests/test_native.py.
"""

import importlib
import io
import os
import random

import numpy as np
import pytest

from lhrs_bot_tpu.core.config import ConfigDict as JConfigDict
from lhrs_bot_tpu.data import conversation as j_conv
from lhrs_bot_tpu.data import datasets as j_ds
from lhrs_bot_tpu.data import loader as j_loader
from lhrs_bot_tpu.data import preprocess as j_pre
from lhrs_bot_tpu.data import tario as j_tario
from lhrs_bot_tpu_torch.core.config import ConfigDict as TConfigDict
from lhrs_bot_tpu_torch.data import conversation as t_conv
from lhrs_bot_tpu_torch.data import datasets as t_ds
from lhrs_bot_tpu_torch.data import loader as t_loader
from lhrs_bot_tpu_torch.data import native as t_native
from lhrs_bot_tpu_torch.data import preprocess as t_pre
from lhrs_bot_tpu_torch.data import tario as t_tario

from .fake_tokenizer import FakeTokenizer
from .torch_corpora import (save_image, write_caption_corpus,
                            write_instruct_corpus, write_shard)

# the modules (the JAX package's data/__init__ exports the function)
j_build = importlib.import_module("lhrs_bot_tpu.data.build_loader")
t_build = importlib.import_module("lhrs_bot_tpu_torch.data.build_loader")

JPEG_LSB = 1


@pytest.fixture(scope="module")
def tok():
    return FakeTokenizer()


def assert_items_equal(got, want, where=""):
    """Items (dicts of arrays, lists and scalars) equal; uint8 images of
    the same shape within JPEG_LSB (0 for the PNG-only callers)."""
    assert type(got) is type(want) or isinstance(got, dict), where
    if isinstance(want, dict):
        assert set(got) == set(want), (where, sorted(got), sorted(want))
        for k in want:
            assert_items_equal(got[k], want[k], f"{where}/{k}")
        return
    if isinstance(want, np.ndarray) and want.dtype == np.uint8 \
            and want.ndim >= 3:
        assert got.shape == want.shape and got.dtype == np.uint8, where
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= JPEG_LSB, (where, diff.max())
        return
    if isinstance(want, (np.ndarray, list, tuple)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=where)
        return
    assert got == want, where


def items(ds, seed):
    random.seed(seed)
    return [ds[i] for i in range(len(ds))]


# -- preprocess ------------------------------------------------------------


@pytest.mark.parametrize("template,has_image", [
    ("plain", True), ("llava_llama_2", True), ("llava_llama_2", False),
    ("llava_v1", True), ("llava_v1", False), ("v1_mmtag", True)])
def test_preprocess_matches_jax(tok, template, has_image):
    """`preprocess` (and through it plain / llama_2 / v1 and the mmtag
    wrap of `preprocess_multimodal`) gives JAX's ids and labels over one
    and three turns (the plain template always carries the image)."""
    j_conv.set_default_conversation(template)
    t_conv.set_default_conversation(template)
    try:
        for turns in (1, 3):
            src = [{"Question": ("<image>\n" if has_image and i == 0 else "")
                    + f"what is at place {i}", "Answer": f"a field {i}"}
                   for i in range(turns if template != "plain" else 1)]
            want = j_pre.preprocess(j_pre.preprocess_multimodal(
                [dict(s) for s in src]), tok, has_image=has_image)
            got = t_pre.preprocess(t_pre.preprocess_multimodal(
                [dict(s) for s in src]), tok, has_image=has_image)
            assert_items_equal(got, want, template)
    finally:
        j_conv.set_default_conversation("llava_llama_2")
        t_conv.set_default_conversation("llava_llama_2")


def test_mask_rounds_mismatch_masks_all(tok):
    """A round whose length does not add up masks the whole target, in
    both packages."""
    conv = "[INST] a [/INST] b </s>garbage"
    for mod in (j_pre, t_pre):
        target = np.arange(40, dtype=np.int64) + 10
        mod._mask_rounds(conv, target, tok, sep="[/INST] ", sep2="</s>",
                         has_image=False)
        assert (target == -100).all()


# -- datasets --------------------------------------------------------------


def test_instruct_dataset_matches_jax(tok, tmp_path):
    """InstructDataset over PNG and JPEG records, a 12-turn record (ten
    turns sampled with the module-level random), a text-only record and a
    missing image (dropped)."""
    root = write_instruct_corpus(str(tmp_path), seed=1)
    jsons = sorted(os.path.join(root, f) for f in os.listdir(root)
                   if f.endswith(".json"))
    roots = [os.path.splitext(j)[0] + "_Image" for j in jsons]
    jd = j_ds.InstructDataset(jsons, roots, tok, image_size=32)
    td = t_ds.InstructDataset(jsons, roots, tok, image_size=32)
    assert len(td) == len(jd) == 10
    for seed in (0, 5):
        for i, (g, w) in enumerate(zip(items(td, seed), items(jd, seed))):
            assert_items_equal(g, w, f"item {i}")
    # the weights: one a kept record (JAX counts the dropped ones too, so
    # its list is longer than its records here)
    tw = t_ds.InstructDatasetWithTaskId(jsons, roots, tok, image_size=32)
    assert tw.sample_weights == [1.0] * 5 + [0.6] * 5 and len(tw) == 10
    jw = j_ds.InstructDatasetWithTaskId(jsons, roots, tok, image_size=32)
    assert len(jw.sample_weights) == 12 and len(jw) == 10


def test_weighted_instruct_dataset_matches_jax(tok, tmp_path):
    """With no record dropped, the per-source weights, the names and the
    items equal JAX's."""
    root = write_instruct_corpus(str(tmp_path), seed=2, missing=False)
    jsons = sorted(os.path.join(root, f) for f in os.listdir(root)
                   if f.endswith(".json"))
    roots = [os.path.splitext(j)[0] + "_Image" for j in jsons]
    jw = j_ds.InstructDatasetWithTaskId(jsons, roots, tok, image_size=32)
    tw = t_ds.InstructDatasetWithTaskId(jsons, roots, tok, image_size=32)
    assert tw.sample_weights == jw.sample_weights
    assert tw.source_names == jw.source_names
    for i, (g, w) in enumerate(zip(items(tw, 1), items(jw, 1))):
        assert_items_equal(g, w, f"item {i}")


def test_caption_datasets_match_jax(tok, tmp_path):
    """CaptionDataset (plain) and CaptionDatasetVQA (random QA templates)
    over a list corpus and an RSICD corpus (a sentence drawn at build)."""
    root = write_caption_corpus(str(tmp_path), seed=2)
    for cls, template in (("CaptionDataset", "plain"),
                          ("CaptionDatasetVQA", "llava_llama_2")):
        random.seed(3)
        jd = getattr(j_ds, cls)(root, tok, image_size=24,
                                prompt_type=template)
        random.seed(3)
        td = getattr(t_ds, cls)(root, tok, image_size=24,
                                prompt_type=template)
        assert len(td) == len(jd) == 12
        assert [r["caption"] for r in td.records] == \
            [r["caption"] for r in jd.records]
        for i, (g, w) in enumerate(zip(items(td, 4), items(jd, 4))):
            assert_items_equal(g, w, f"{cls} {i}")
    j_conv.set_default_conversation("llava_llama_2")
    t_conv.set_default_conversation("llava_llama_2")


def _rsvqa_corpus(root, prefix, rng, n_img=3):
    import json

    qtypes = ["presence", "count", "comp", "area", "rural_urban"]
    questions, answers = [], []
    for i in range(n_img * 3):
        questions.append({"id": i, "img_id": i % n_img,
                          "active": i != 4, "type": qtypes[i % 5],
                          "question": f"is there a road {i}?",
                          "answers_ids": [i]})
        answers.append({"id": i, "answer": "yes" if i % 2 else "no"})
    for kind, payload in (("questions", questions), ("answers", answers)):
        with open(os.path.join(root, f"{prefix}_split_test_{kind}.json"),
                  "w") as fh:
            json.dump({kind: payload}, fh)
    os.makedirs(os.path.join(root, "Images_LR"), exist_ok=True)
    for i in range(n_img):
        save_image(os.path.join(root, "Images_LR", f"{i}.tif"), rng, 30, 26,
                   "TIFF")


@pytest.mark.parametrize("variant", ["LR", "HR", "XBEN"])
def test_rsvqa_matches_jax(tok, tmp_path, variant):
    prefix = {"LR": "LR", "HR": "USGS", "XBEN": "RSVQAxBEN"}[variant]
    _rsvqa_corpus(str(tmp_path), prefix, np.random.default_rng(3))
    jd = j_ds.RSVQA_VARIANTS[variant](str(tmp_path), tok, image_size=24)
    td = t_ds.RSVQA_VARIANTS[variant](str(tmp_path), tok, image_size=24)
    assert td.items == jd.items and len(td) == len(jd) == 4
    for g, w in zip(items(td, 0), items(jd, 0)):
        assert_items_equal(g, w, variant)


def test_eval_datasets_match_jax(tok, tmp_path):
    """VGEvalDataset (DIOR layout: ".jpg" appended), CapEvalDataset (the
    RSICD and NWPU layouts) and LHRSBenchDataset."""
    import json

    rng = np.random.default_rng(4)
    root = str(tmp_path)
    for i in range(3):
        save_image(os.path.join(root, f"v{i}.jpg"), rng, 36, 30, "JPEG")
        save_image(os.path.join(root, f"p{i}.png"), rng, 30, 40, "PNG")
    vg = os.path.join(root, "DIOR_test.json")
    with open(vg, "w") as fh:
        json.dump({"data": [{"img": f"v{i}", "question": f"where is {i}",
                             "answer": [1, 2, 3, 4]} for i in range(4)]}, fh)
    jd = j_ds.VGEvalDataset(root, vg, tok, image_size=24)
    td = t_ds.VGEvalDataset(root, vg, tok, image_size=24)
    assert len(td) == len(jd) == 3
    for g, w in zip(items(td, 0), items(jd, 0)):
        assert_items_equal(g, w, "vg")
    cap = os.path.join(root, "caps.json")
    with open(cap, "w") as fh:
        json.dump({"images": [{"filename": f"p{i}.png", "sentences": [
            {"raw": f"cap {i}"}]} for i in range(4)]}, fh)
    nwpu = os.path.join(root, "nwpu.json")
    with open(nwpu, "w") as fh:
        json.dump({".": [{"filename": f"p{i}.png", "raw": f"n {i}"}
                         for i in range(3)]}, fh)
    for target in (cap, nwpu):
        jd = j_ds.CapEvalDataset(root, target, image_size=24)
        td = t_ds.CapEvalDataset(root, target, image_size=24)
        assert len(td) == len(jd) == 3
        for g, w in zip(items(td, 0), items(jd, 0)):
            assert_items_equal(g, w, "cap")
    bench = os.path.join(root, "bench.json")
    with open(bench, "w") as fh:
        json.dump({"qtype": {"1 color": 0, "2 count": 0},
                   "data": [{"filename": f"p{i}.png", "qa_pairs": [
                       {"question": f"q{i}{j}", "choices": ["a", "b"],
                        "answer": "a", "type": "1"} for j in range(2)]}
                       for i in range(3)]}, fh)
    jd = j_ds.LHRSBenchDataset(root, bench, image_size=24)
    td = t_ds.LHRSBenchDataset(root, bench, image_size=24)
    assert td.id_to_type == jd.id_to_type and len(td) == len(jd) == 6
    for g, w in zip(items(td, 0), items(jd, 0)):
        assert_items_equal(g, w, "bench")


def test_classification_datasets_match_jax(tmp_path):
    """The folder, Million-AID, txt-split and METER-ML forms."""
    import json

    rng = np.random.default_rng(5)
    root = str(tmp_path / "folder")
    for c, cls in enumerate(("airport", "beach")):
        os.makedirs(os.path.join(root, cls))
        for i in range(2):
            save_image(os.path.join(root, cls, f"{i}.{'jpg' if i else 'png'}"),
                       rng, 28 + c, 34, "JPEG" if i else "PNG")
    split = str(tmp_path / "split.txt")
    with open(split, "w") as fh:
        fh.write("airport/0.png 0\nbeach/1.jpg 1\n")
    meter = str(tmp_path / "meter")
    feats = []
    for i, label in enumerate(("Landfills", "Mines|CAFOs", "Unknown")):
        os.makedirs(os.path.join(meter, f"site{i}"))
        save_image(os.path.join(meter, f"site{i}", "naip.png"), rng, 30, 30,
                   "PNG")
        feats.append({"properties": {"Type": label,
                                     "Image_Folder": f"site{i}"}})
    with open(os.path.join(meter, "test_dataset.geojson"), "w") as fh:
        json.dump({"features": feats}, fh)
    pairs = [(t_ds.FolderClassificationDataset(root, image_size=24),
              j_ds.FolderClassificationDataset(root, image_size=24)),
             (t_ds.MillionAidEval(root, image_size=24),
              j_ds.MillionAidEval(root, image_size=24)),
             (t_ds.TxtSplitClassificationDataset(root, split, image_size=24,
                                                 class_names=["a", "b"]),
              j_ds.TxtSplitClassificationDataset(root, split, image_size=24,
                                                 class_names=["a", "b"])),
             (t_ds.METERMLDataset(meter, image_size=24),
              j_ds.METERMLDataset(meter, image_size=24))]
    for td, jd in pairs:
        assert td.samples == jd.samples and td.class_names == jd.class_names
        for g, w in zip(items(td, 0), items(jd, 0)):
            assert_items_equal(g, w, type(td).__name__)


def test_valid_path_and_sniff_match_jax(tmp_path):
    import json

    (tmp_path / "a.png").write_bytes(b"x")
    entries = [{"image": "a.png"}, {"image": "b.png"}, {}]
    assert t_ds.valid_path(str(tmp_path), entries) == \
        j_ds.valid_path(str(tmp_path), entries)
    for data in ({"images": [{"filename": "a", "sentences": [
            {"raw": "x"}, {"raw": "y"}, "z"]}]},
            {"k": {"image": "a", "caption": "c"}},
            [{"filename": "a", "sentence": "s"},
             {"conversations": []}, 3]):
        path = str(tmp_path / "ann.json")
        with open(path, "w") as fh:
            json.dump(data, fh)
        random.seed(1)
        want = j_ds.sniff_annotations(path)
        random.seed(1)
        assert t_ds.sniff_annotations(path) == want


def test_native_library_matches_pil(tmp_path):
    """The port's build of native/lhrs_host.cc (under build/host/, never
    in native/): JPEG decode + resize within 1 LSB of PIL, a corrupt
    buffer flagged with a zero slot, `resize_batch` within 1 LSB of the
    PIL-exact resize."""
    from PIL import Image

    from lhrs_bot_tpu_torch.data.transforms import clip_preprocess_uint8

    from .torch_corpora import image_bytes

    if not t_native.available():
        pytest.skip(f"no native build here: {t_native.build_log_path()}")
    assert "build" in str(t_native.library_path())
    assert not os.path.exists(os.path.join(
        os.path.dirname(t_native.SOURCE), "liblhrs_host.so"))
    rng = np.random.default_rng(6)
    bufs = [image_bytes(rng, 90 + 10 * i, 70, "JPEG") for i in range(3)]
    out, ok = t_native.decode_resize_batch(bufs + [b"garbage"], size=48)
    assert ok.tolist() == [True, True, True, False] and out[3].max() == 0
    for i, buf in enumerate(bufs):
        want = clip_preprocess_uint8(np.asarray(Image.open(
            io.BytesIO(buf)).convert("RGB")), 48)
        assert np.abs(out[i].astype(int) - want.astype(int)).max() <= 1
    imgs = [rng.integers(0, 255, (64, 50, 3)).astype(np.uint8),
            rng.integers(0, 255, (40, 80, 3)).astype(np.uint8)]
    got = t_native.resize_batch(imgs, size=32)
    for g, img in zip(got, imgs):
        want = clip_preprocess_uint8(img, 32)
        assert np.abs(g.astype(int) - want.astype(int)).max() <= 1


def test_native_library_that_does_not_load(tmp_path, monkeypatch):
    """A library that exists but does not load (built on a machine with
    libjpeg, copied to one without) counts as not built: the error goes to
    the build log, and the decode falls back to PIL."""
    bogus = tmp_path / "h" / "liblhrs_host.so"
    bogus.parent.mkdir()
    bogus.write_bytes(b"not a shared object")
    monkeypatch.setattr(t_native, "library_path", lambda: bogus)
    monkeypatch.setattr(t_native, "_STATE", {"tried": False, "lib": None})
    assert t_native.load_library() is None and not t_native.available()
    assert "loading" in (tmp_path / "h" / "build.log").read_text()
    assert t_native.jpeg_decoder() == "PIL"
    from .torch_corpora import image_bytes

    out, ok = t_native.decode_resize_batch(
        [image_bytes(np.random.default_rng(0), 30, 40, "JPEG")], size=16)
    assert ok.tolist() == [True] and out.std() > 0


def test_jpeg_without_library_or_pil_raises(tmp_path, monkeypatch):
    """With no native library and no PIL, a JPEG raises an error naming
    the build log: never a zero image, never a dropped sample."""
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(t_native, "load_library", lambda: None)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(RuntimeError, match="build.log"):
        t_native.decode_resize_batch([b"\xff\xd8\xff"], size=8)
    with pytest.raises(RuntimeError, match="build.log"):
        t_tario.default_decoder({"jpg": b"\xff\xd8", "txt": b"c"}, 8)


# -- samplers and loader ---------------------------------------------------


@pytest.mark.parametrize("world,drop_last", [(1, False), (3, False),
                                             (3, True)])
def test_samplers_match_jax(world, drop_last):
    for seed in (0, 7):
        for rank in range(world):
            js = j_loader.ShardedSampler(10, rank, world, True, seed,
                                         drop_last)
            ts = t_loader.ShardedSampler(10, rank, world, True, seed,
                                         drop_last)
            for epoch in (0, 1, 4):
                js.set_epoch(epoch)
                ts.set_epoch(epoch)
                assert list(ts) == list(js) and len(ts) == len(js)
            weights = np.linspace(0.1, 1.0, 9)
            jw = j_loader.WeightedShardedSampler(weights, 30, rank, world,
                                                 seed)
            tw = t_loader.WeightedShardedSampler(weights, 30, rank, world,
                                                 seed)
            for epoch in (0, 2):
                jw.set_epoch(epoch)
                tw.set_epoch(epoch)
                assert list(tw) == list(jw) and len(tw) == len(jw)
            ji = iter(j_loader.InfiniteSampler(7, rank, world, True, seed))
            ti = iter(t_loader.InfiniteSampler(7, rank, world, True, seed))
            assert [next(ti) for _ in range(25)] == \
                [next(ji) for _ in range(25)]


class _DS:
    def __len__(self):
        return 11

    def __getitem__(self, i):
        return {"x": np.full((3,), i), "r": random.random()}


def _coll(items_):
    return {"x": np.stack([it["x"] for it in items_]),
            "r": np.asarray([it["r"] for it in items_])}


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("drop_last", [True, False])
def test_dataloader_batches_match_jax(workers, drop_last):
    """The DataLoader's batches (and its length) over the same sampler;
    with one worker the module-level random draws match too."""
    def run(mod, epoch):
        random.seed(9)
        dl = mod.DataLoader(_DS(), batch_size=3, collate_fn=_coll,
                            num_workers=workers, drop_last=drop_last,
                            seed=2)
        dl.set_epoch(epoch)
        return len(dl), list(dl)

    for epoch in (0, 1):
        (tn, tb), (jn, jb) = run(t_loader, epoch), run(j_loader, epoch)
        assert tn == jn and len(tb) == len(jb) == tn
        for g, w in zip(tb, jb):
            np.testing.assert_array_equal(g["x"], w["x"])
            if workers == 1:
                np.testing.assert_array_equal(g["r"], w["r"])


def test_dataloader_error_and_close():
    """A worker's error reaches the consumer; closing the iterator stops
    the producer thread (it is not left running)."""
    class Bad:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(t_loader.DataLoader(Bad(), batch_size=2, collate_fn=lambda x: x,
                                 num_workers=1))
    import threading

    before = threading.active_count()
    it = iter(t_loader.DataLoader(_DS(), batch_size=1, collate_fn=_coll,
                                  num_workers=2, prefetch=1))
    next(it)
    it.close()
    assert threading.active_count() == before


# -- tar shards ------------------------------------------------------------


def test_braceexpand_and_opener(tmp_path):
    for pat in ("s-{00..03}.tar", "plain.tar", "a{1..2}b{08..09}"):
        assert t_tario.braceexpand(pat) == j_tario.braceexpand(pat)
    p = tmp_path / "x.bin"
    p.write_bytes(b"abc")
    for url in (str(p), f"pipe:cat {p}"):
        fh, close = t_tario.url_opener(url)
        assert fh.read() == b"abc"
        close()


@pytest.mark.parametrize("pipe", [False, True])
@pytest.mark.parametrize("image_size", [None, 24])
def test_tar_streams_match_jax(tmp_path, pipe, image_size):
    """Equal sample streams over local and `pipe:` shards, a corrupt
    sample skipped by both, a failing pipe skipped, the shard shuffle,
    the shuffle buffer and the rank split."""
    import functools

    paths = [write_shard(str(tmp_path / f"a{i}.tar"), i, n=4,
                         corrupt=(2,) if i == 0 else (),
                         fmt="PNG" if i == 2 else "JPEG") for i in range(3)]
    urls = [f"pipe:cat {p}" if pipe else p for p in paths]
    if pipe:
        urls.append("pipe:false")
    for kw in ({"shuffle_buffer": 0, "shuffle_shards": False},
               {"shuffle_buffer": 3, "seed": 5},
               {"shuffle_buffer": 0, "rank": 1, "world_size": 2,
                "seed": 1}):
        streams = []
        for mod in (t_tario, j_tario):
            ds = mod.TarShardDataset(
                urls, decoder=functools.partial(mod.default_decoder,
                                                image_size=image_size), **kw)
            ds.set_epoch(1)
            streams.append(list(ds))
        got, want = streams
        assert len(got) == len(want) > 0
        assert [s["text"] for s in got] == [s["text"] for s in want]
        for g, w in zip(got, want):
            assert_items_equal(g["rgb"], w["rgb"], g["text"])
    if not pipe:
        n = len(list(t_tario.TarShardDataset(paths, shuffle_buffer=0)))
        assert n == 11  # 12 samples, one corrupt


def test_rs5m_matches_jax(tok, tmp_path):
    paths = [write_shard(str(tmp_path / f"r{i}.tar"), 10 + i, n=3)
             for i in range(2)]
    streams = []
    for mod, conv in ((t_tario, t_conv), (j_tario, j_conv)):
        conv.set_default_conversation("llava_llama_2")
        random.seed(2)
        ds = mod.RS5MDataset(paths, tok, image_size=24, shuffle_buffer=2,
                             num_samples=6, seed=3)
        assert len(ds) == 6
        streams.append(list(ds))
    for g, w in zip(*streams):
        assert_items_equal(g, w, "rs5m")


# -- build_loader ----------------------------------------------------------


def _configs(**kw):
    base = {"stage": 2, "prompt_template": "llava_llama_2",
            "batch_size": 2, "workers": 1, "seed": 3,
            "rgb_vision": {"input_size": [24, 24]}}
    base.update(kw)
    return TConfigDict(base), JConfigDict(base)


@pytest.mark.parametrize("route", ["caption", "tar", "instruct", "weighted",
                                   "packed"])
def test_build_loader_routes_match_jax(tok, tmp_path, route):
    """Each route of `build_loader`: stage-1 captions, the stage-1 tar
    stream, stage-2 instructions, stage-3 weight_sample, and
    pack_sequences; the first epoch's batches equal JAX's."""
    root = str(tmp_path)
    if route == "caption":
        write_caption_corpus(root, seed=7)
        kw = {"stage": 1, "data_path": root, "prompt_template": "plain"}
    elif route == "tar":
        for i in range(2):
            write_shard(os.path.join(root, f"sh-{i:02d}.tar"), i, n=3)
        kw = {"stage": 1, "data_path": os.path.join(root, "sh-{00..01}.tar")}
    else:
        # no record dropped where the weights count (JAX's count them all)
        write_instruct_corpus(root, seed=8, jpeg=route != "packed",
                              missing=route != "weighted")
        kw = {"data_path": root}
        if route == "weighted":
            kw.update(stage=3, weight_sample=True)
        if route == "packed":
            kw.update(pack_sequences=True, pack_factor=2, batch_size=4,
                      pack_target_len=256)
    tcfg, jcfg = _configs(**kw)
    loaders, batches = [], []
    for mod, cfg in ((t_build, tcfg), (j_build, jcfg)):
        random.seed(11)
        loader = mod.build_loader(cfg, tok, mode="pretrain")
        loaders.append(loader)
        if route == "tar":
            loader.dataset.num_samples = 6
        batches.append(list(loader))
    (tl, jl), (tb, jb) = loaders, batches
    assert type(tl).__name__ == type(jl).__name__
    assert type(getattr(tl, "sampler", None)).__name__ == \
        type(getattr(jl, "sampler", None)).__name__
    assert len(tl) == len(jl) and len(tb) == len(jb) > 0
    for g, w in zip(tb, jb):
        assert_items_equal(g, w, route)
    j_conv.set_default_conversation("llava_llama_2")
    t_conv.set_default_conversation("llava_llama_2")


def test_build_zero_shot_loader(tmp_path):
    rng = np.random.default_rng(9)
    for cls in ("a", "b"):
        os.makedirs(tmp_path / cls)
        save_image(str(tmp_path / cls / "0.png"), rng, 20, 20, "PNG")
    tcfg, jcfg = _configs(data_path=str(tmp_path))
    tds, tnames = t_build.build_zero_shot_loader(tcfg)
    jds, jnames = j_build.build_zero_shot_loader(jcfg)
    assert tnames == jnames == ["a", "b"]
    for g, w in zip(items(tds, 0), items(jds, 0)):
        assert_items_equal(g, w, "cls")
