"""The real encoder suite end to end on the CPU: a snapshot directory this
test writes (tiny configs in config.json, random weights in safetensors, a
WordLevel tokenizer built in memory with the `tokenizers` library and saved
as tokenizer.json; nothing fetched) loaded by
`RealTextEncoders.from_pretrained` and by `load_text_encoders`, and sampled
through `infer.main(... --encoder_weights DIR)` and `infer_loop.main` from a
tiny MMDiT checkpoint sized to the suite's widths. The suite is held to the
JAX suite's wiring (`combine_hidden`, the BERT mask) on the same ids.
"""

import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from sd3_torch.config import tiny_config
from sd3_torch.inference import infer, infer_loop
from sd3_torch.models import encoder_suite as es
from sd3_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from sd3_torch.models.gemma2 import Gemma2Config, Gemma2Encoder
from sd3_torch.models.modernbert import ModernBertConfig, ModernBertEncoder
from sd3_torch.models.text_encoders import load_text_encoders
from sd3_torch.models.vae import FluxVAE, VAEConfig
from sd3_torch.models.mmdit import MMDiT
from sd3_torch.training import checkpoint as tck
from sd3_torch.weights import jax_tree_from_state_dict

pytest.importorskip("transformers")

WORDS = ["a", "red", "fox", "blue", "cat", "on", "the", "hill", "at", "dawn"]
GEMMA, BERT, CLIP = (Gemma2Config.tiny(), ModernBertConfig.tiny(),
                     ClipTextConfig.tiny())


def _tokenizer(path):
    from tokenizers import Tokenizer, models, pre_tokenizers
    vocab = {"[PAD]": 0, "[UNK]": 1, **{w: i + 2 for i, w in enumerate(WORDS)}}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "pad_token": "[PAD]", "unk_token": "[UNK]",
                   "model_max_length": 77}, f)


def _config(path, cfg, **extra):
    raw = {**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__}, **extra}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(raw, f)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """<dir>/{gemma-2-2b, modernbert-large, metaclip-l14, flux-vae}: tiny
    networks under transformers' / diffusers' key names (Gemma-2 and
    ModernBERT with a causal LM's `model.` prefix and a head to drop, CLIP
    as a whole CLIPModel with a vision key to drop)."""
    from safetensors.torch import save_file
    root = tmp_path_factory.mktemp("weights")
    torch.manual_seed(3)
    nets = {"gemma-2-2b": Gemma2Encoder(GEMMA, device="cpu"),
            "modernbert-large": ModernBertEncoder(BERT, device="cpu"),
            "metaclip-l14": ClipTextEncoder(CLIP, device="cpu"),
            "flux-vae": FluxVAE(VAEConfig.tiny(), device="cpu")}
    for name, net in nets.items():
        d = root / name
        d.mkdir()
        sd = {k: v.contiguous() for k, v in net.state_dict().items()}
        if name in ("gemma-2-2b", "modernbert-large"):
            sd = {"model." + k: v for k, v in sd.items()}
            sd["lm_head.weight"] = torch.zeros(2, 2)
            _config(d, net.cfg)
        elif name == "metaclip-l14":
            sd["vision_model.post_layernorm.weight"] = torch.zeros(2)
            text = {k: getattr(CLIP, k) for k in CLIP.__dataclass_fields__}
            with open(d / "config.json", "w") as f:
                json.dump({"text_config": text,
                           "projection_dim": CLIP.projection_dim}, f)
        else:
            with open(d / "config.json", "w") as f:
                json.dump({"block_out_channels": [32, 32, 32, 32],
                           "layers_per_block": 1, "latent_channels": 16}, f)
        save_file(sd, str(d / "model.safetensors"))
        if name != "flux-vae":
            _tokenizer(str(d))
    return root, nets


def test_from_pretrained_loads_each_network_and_wires_the_suite(snapshot):
    root, nets = snapshot
    suite = es.RealTextEncoders.from_pretrained(str(root), device="cpu")
    assert suite.gemma.cfg == GEMMA and suite.clip.cfg == CLIP
    assert suite.vae.cfg == VAEConfig.tiny()
    for got, want in ((suite.gemma, nets["gemma-2-2b"]),
                      (suite.bert, nets["modernbert-large"]),
                      (suite.clip, nets["metaclip-l14"]),
                      (suite.vae, nets["flux-vae"])):
        for k, v in want.state_dict().items():
            assert torch.equal(got.state_dict()[k].float(), v.to(
                got.state_dict()[k].dtype).float()), k
    assert suite.gemma.dtype == suite.bert.dtype == torch.bfloat16
    assert suite.clip.dtype == torch.float16
    hidden, pooled = suite.text_to_embedding(["a red fox", "a blue cat on"])
    assert hidden.shape == (2, 154, GEMMA.hidden_size)
    assert pooled.shape == (2, CLIP.projection_dim)
    assert pooled.dtype == torch.float32
    assert torch.isfinite(hidden.float()).all()
    # the JAX suite's wiring on the same ids: gemma || zero-padded BERT
    # times its mask, CLIP's projected pooled output
    gt, bt, ct = suite.tokenizers
    g = gt(["a red fox"], return_tensors="pt", padding="max_length",
           max_length=77)
    b = bt(["a red fox"], return_tensors="pt", padding="max_length",
           max_length=77)
    assert int(b["attention_mask"].sum()) == 3
    want_g = suite.gemma(g["input_ids"], g["attention_mask"])
    want_b = suite.bert(b["input_ids"], b["attention_mask"])
    assert torch.equal(hidden[:1, :77], want_g)
    assert torch.equal(hidden[:1, 77:80, :BERT.hidden_size], want_b[:, :3])
    assert not hidden[:1, 80:].any()
    z = torch.randn(1, 16, 2, 2, generator=torch.Generator().manual_seed(1))
    img = suite.vae_decode(z)
    assert img.shape == (1, 3, 16, 16) and float(img.abs().max()) <= 1
    lat = suite.vae_encode(img, torch.Generator().manual_seed(2))
    assert lat.shape == (1, 16, 2, 2)


def _checkpoint(path):
    """A tiny MMDiT at the suite's widths (16 latent channels, 77 + 77 text
    tokens of Gemma's hidden size, CLIP's projection)."""
    cfg = tiny_config(inCh=16, text_tokens_per_encoder=77,
                      text_hidden_dim=GEMMA.hidden_size,
                      class_dim=CLIP.projection_dim, max_res=32,
                      max_res_orig=32, pos_embed_max_size=32)
    torch.manual_seed(5)
    model = MMDiT(cfg, device="cpu")
    tck.save_checkpoint(str(path), cfg,
                        jax_tree_from_state_dict(model.state_dict()), step=1)


def test_infer_cli_samples_through_the_real_suite(snapshot, tmp_path):
    root, _ = snapshot
    enc = load_text_encoders(device="cpu", weights_dir=str(root))
    assert isinstance(enc, es.RealTextEncoders)
    _checkpoint(tmp_path)
    out = tmp_path / "fig"
    args = ["--loadDir", str(tmp_path), "--step", "1", "--num_steps", "2",
            "--guidance", "5", "--width", "16", "--height", "16", "--seed",
            "7", "--batch_size", "2", "--encoder_weights", str(root),
            "--device", "cpu"]
    infer.main([*args, "--text_input", "a red fox", "--out_imgname",
                str(out)])
    for i in range(2):
        with Image.open(f"{out}_{i}.png") as im:
            assert im.size == (16, 16)
    # the loop: two prompts from stdin, one checkpoint and suite load
    loop = tmp_path / "loop"
    infer_loop.main([*args, "--out_imgname", str(loop)],
                    stdin=io.StringIO("a red fox\n\nthe blue cat\nquit\n"))
    for i in range(2):
        for j in range(2):
            assert os.path.isfile(f"{loop}_{i}_{j}.png")
    assert not os.path.exists(f"{loop}_2_0.png")
    # one prompt through infer and through the loop: the same first image
    # (one seed, the same first draw)
    a = np.asarray(Image.open(f"{out}_0.png"))
    b = np.asarray(Image.open(f"{loop}_0_0.png"))
    assert np.array_equal(a, b)
