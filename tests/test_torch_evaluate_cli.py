"""The port's evaluation CLI (custom_diffusion360_torch.cli.evaluate) on the
CPU: ``--smoke`` writes its three scores, and on PNG folders, torch-named
``.pth`` checkpoints and a synthetic BPE merges file written here, its FID,
CLIP-I and CLIP-T equal the JAX package's functions on the same files
(JAX's own loaders, ``_load_images`` and tokenizer).

The CLI reads its CLIP checkpoints at the ViT-H/14 widths; the tests swap
in small towers (tests/test_torch_eval.py's, with the head dimension 80)
for both sides. Tolerance: 1e-4 relative for every score (Inception's
features to 1e-4 of their scale, tests/test_torch_eval.py, then float64
statistics; the CLIP cosines to 1e-5).
"""
import gzip
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_diffusion360_tpu.cli import evaluate as jcli
from custom_diffusion360_tpu.data.tokenizer import ClipTokenizer as JTokenizer
from custom_diffusion360_tpu.eval.clip_score import clip_image_similarity as j_clip_i
from custom_diffusion360_tpu.eval.clip_score import clip_score as j_clip_t
from custom_diffusion360_tpu.eval.inception import load_inception_torch as j_load_inception
from custom_diffusion360_tpu.io.torch_convert import convert_open_clip_state_dict as j_convert
from custom_diffusion360_tpu.models import clip as jclip
from custom_diffusion360_torch.cli import evaluate as cli
from custom_diffusion360_torch.cli.sample import write_png
from custom_diffusion360_torch.models import clip as tclip
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)
from tests.test_torch_eval import TEXT, VISION, inception_state_dict, open_clip_state_dict

pytestmark = pytest.mark.usefixtures("torch_threads")

MERGES = ["p h", "o t", "ph ot", "o </w>", "c a", "ca r</w>", "o f</w>", "a </w>"]


@pytest.fixture()
def files(tmp_path, monkeypatch):
    """Two PNG folders of four images (generated: brighter, 24 x 24; real:
    darker, 32 x 32, which the CLI resizes to 24), one Inception and one
    open_clip (vision + text) checkpoint, a merges file; the CLI's towers
    made small."""
    rng = np.random.default_rng(11)
    for name, n, size, lo, hi in (("gen", 4, 24, 80, 256), ("real", 4, 32, 0, 176)):
        (tmp_path / name).mkdir()
        for i in range(n):
            img = rng.integers(lo, hi, (size, size, 3)).astype(np.uint8)
            write_png(str(tmp_path / name / f"{i:02d}.png"), img)
    torch.save(inception_state_dict(seed=12), tmp_path / "inception.pth")
    vcfg, tcfg = tclip.ClipVisionConfig(**VISION), tclip.ClipTextConfig(**TEXT)
    torch.save(open_clip_state_dict(vcfg, tcfg, seed=13), tmp_path / "clip.pth")
    (tmp_path / "vocab").mkdir()
    with gzip.open(tmp_path / "vocab" / "bpe_simple_vocab_16e6.txt.gz", "wt") as f:
        f.write("\n".join(["#version: synthetic"] + MERGES) + "\n")
    monkeypatch.setattr(cli, "ClipVisionConfig", lambda: vcfg)
    monkeypatch.setattr(cli, "VIT_H14_TEXT", tcfg)
    return tmp_path


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_port_evaluate_smoke_writes_three_scores(tmp_path):
    out = tmp_path / "metrics.json"
    metrics = cli.main(["--smoke", "--device", "cpu", "--output", str(out)])
    assert sorted(metrics) == ["clip_i", "clip_t", "fid"]
    assert json.loads(out.read_text()) == metrics
    assert all(np.isfinite(v) for v in metrics.values())


def test_port_evaluate_fid_and_clip_i_match_jax_on_files(files):
    d = files
    got = cli.main(["--generated", str(d / "gen"), "--real", str(d / "real"),
                    "--inception_ckpt", str(d / "inception.pth"),
                    "--clip_vision_ckpt", str(d / "clip.pth"), "--batch", "3",
                    "--device", "cpu"])
    assert sorted(got) == ["clip_i", "fid"]
    gen = jcli._load_images(jcli._list_images(str(d / "gen")))
    real = jcli._load_images(jcli._list_images(str(d / "real")), size=gen.shape[1])
    # JAX in one batch (each new batch shape compiles anew), the port in 3s
    want_fid = jcli.compute_fid(j_load_inception(_load(d / "inception.pth")), gen, real, 8)
    vp = jclip.load_clip_vision_torch(_load(d / "clip.pth"), jclip.ClipVisionConfig(**VISION))
    want_i = float(np.mean(np.asarray(j_clip_i(vp, jnp.asarray(gen * 2 - 1),
                                               jnp.asarray(real * 2 - 1),
                                               jclip.ClipVisionConfig(**VISION)))))
    # random Inception weights squash the pool3 features together, so the
    # FID of even these two sets is small; it is not zero
    assert want_fid > 1e-6
    assert abs(got["fid"] - want_fid) <= 1e-4 * abs(want_fid)
    assert abs(got["clip_i"] - want_i) <= 1e-4 * abs(want_i)


def test_port_evaluate_clip_t_matches_jax(files):
    """The <newN> token is stripped and the prompt tokenized without it,
    through the merges file; the text tower comes from the same file,
    without its visual.* keys."""
    d = files
    prompt = "photo of a <new1> car"
    got = cli.main(["--generated", str(d / "gen"), "--prompt", prompt,
                    "--clip_vision_ckpt", str(d / "clip.pth"), "--vocab_dir", str(d / "vocab"),
                    "--device", "cpu", "--output", str(d / "m.json")])
    assert sorted(got) == ["clip_t"]
    sd = _load(d / "clip.pth")
    jv, jt = jclip.ClipVisionConfig(**VISION), jclip.ClipTextConfig(**TEXT)
    vp = jclip.load_clip_vision_torch(sd, jv)
    tp = j_convert({k: np.asarray(v) for k, v in sd.items() if not k.startswith("visual.")},
                   jt, prefix="")
    gen = jcli._load_images(jcli._list_images(str(d / "gen")))
    tok = JTokenizer.from_merges(str(d / "vocab" / "bpe_simple_vocab_16e6.txt.gz"))
    tokens = jnp.asarray(tok(["photo of a car"] * len(gen)))
    assert int(tokens.max()) < TEXT["vocab_size"]
    want = float(np.mean(np.asarray(j_clip_t(vp, tp, jnp.asarray(gen * 2 - 1), tokens, jv, jt))))
    assert abs(got["clip_t"] - want) <= 1e-4 * abs(want)
    with pytest.raises(SystemExit, match="vocab_dir"):
        cli.main(["--generated", str(d / "gen"), "--prompt", prompt,
                  "--clip_vision_ckpt", str(d / "clip.pth"), "--device", "cpu"])
