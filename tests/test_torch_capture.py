"""``forward(capture=True)``: the port's per-layer captures against the
reference's.

Reduced f32 models, params from the reference's init carried across with
``bridge.from_reference``, the same numpy tokens (and, for the vlm, image
embeddings) through both packages' ``api.forward(..., capture=True)``:

- dense (reduced gemma2 at 5 layers, "LGLGL": the unit "LG" stacked
  twice and one tail layer), moe (reduced qwen2-moe), vlm
  (reduced paligemma, whose captures hold its image positions): the
  ``"blocks"`` list (one [R, B, S, d] tensor per pattern-unit member)
  and the ``"tail"`` list;
- hybrid (reduced zamba2: the groups' inputs [G, B, S, d]) and rwkv
  (the layers' inputs [L, B, S, d]), ``"tail"`` empty;
- ``final_hidden`` (after the final norm) and the logits;
- encdec (reduced whisper) accepts ``capture`` and returns no captures,
  as the reference's does.

Structure equal (keys, list lengths, shapes); values within 1e-5 of the
largest reference value; remat makes no difference to the captures.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rregistry  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference  # noqa: E402
from repro_torch.models import api  # noqa: E402

RTOL = 1e-5
CASES = {
    "dense": ("gemma2-2b", dict(n_layers=5, attn_pattern="LGLGL")),
    "moe": ("qwen2-moe-a2.7b", {}),
    "vlm": ("paligemma-3b", {}),
    "hybrid": ("zamba2-7b", dict(n_layers=7)),
    "rwkv": ("rwkv6-3b", {}),
    "encdec": ("whisper-base", {}),
}


def _rel(got, want):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _inputs(rcfg, B=2, S=16):
    r = np.random.default_rng(3)
    toks = r.integers(4, min(rcfg.vocab_size, 256), (B, S)).astype(np.int32)
    rb, pb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if rcfg.family == "vlm":
        img = (r.standard_normal((B, rcfg.n_img_tokens, rcfg.d_model)) * 0.5).astype(np.float32)
        rb["img_embs"], pb["img_embs"] = jnp.asarray(img), torch.from_numpy(img)
    if rcfg.family == "encdec":
        enc = (r.standard_normal((B, rcfg.enc_ctx, rcfg.d_model)) * 0.5).astype(np.float32)
        rb["enc_inputs"], pb["enc_inputs"] = jnp.asarray(enc), torch.from_numpy(enc)
    return rb, pb


@pytest.mark.parametrize("family", sorted(CASES))
def test_captures_match_reference(family):
    arch, kw = CASES[family]
    rcfg = rregistry.get_reduced(arch).replace(param_dtype="float32", **kw)
    rparams = rapi.init_params(jax.random.PRNGKey(0), rcfg)
    cfg, params = from_reference(rcfg), bridge.from_reference(jax.device_get(rparams),
                                                               device="cpu")
    rb, pb = _inputs(rcfg)
    rlogits, raux = rapi.forward(rparams, rcfg, rb, capture=True)
    with torch.no_grad():
        logits, aux = api.forward(params, cfg, pb, capture=True)
    _, aux_remat = api.forward(params, cfg, pb, capture=True, remat=True)   # grad mode on
    assert _rel(logits, rlogits) <= RTOL
    if family == "encdec":
        assert "captures" not in raux and set(aux) == set(raux) == {"moe_aux"}
        return
    assert set(aux) == set(raux) == {"moe_aux", "captures", "final_hidden"}
    caps, rcaps = aux["captures"], raux["captures"]
    assert set(caps) == set(rcaps) == {"blocks", "tail"}
    assert len(caps["blocks"]) == len(rcaps["blocks"]) and len(caps["tail"]) == len(
        rcaps["tail"])
    for got, want in zip(caps["blocks"] + caps["tail"], rcaps["blocks"] + rcaps["tail"]):
        assert _rel(got, want) <= RTOL
    assert _rel(aux["final_hidden"], raux["final_hidden"]) <= RTOL
    if family == "dense":
        assert len(caps["tail"]) == 1 and caps["blocks"][0].shape[0] == 2
    if family == "vlm":                     # image positions ahead of the text
        assert caps["blocks"][0].shape[2] == rcfg.n_img_tokens + pb["tokens"].shape[1]
    for a, b in zip(aux_remat["captures"]["blocks"], caps["blocks"]):
        assert torch.equal(a, b)
