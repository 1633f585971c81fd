"""The dry run's per-device collectives of the vlm family (paligemma-3b, 2
layers, its 256 image positions ahead of 64 text tokens) held to the
reference's compiled HLO (``torch_hlo_gate.hold``), FSDP off and on:

- at the tool's default shape (4 x 64 on (2, 4)): the sequence split's
  gathers of k and v (one KV head, not split over "model") and their
  RoPE halves, the text slice's gradient, and the recomputation leaving
  out the MLP's last linear;
- at ``--batch 1``, its positions over "data": XLA splits the image and
  the text together over "data" and keeps them split over "model" along
  the features (the image's split), where the port's pieces each hold
  the image whole; with FSDP it keeps the weights split.
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_hlo_gate as G  # noqa: E402

PORT_ONLY = {"column_outputs", "row_input_gradients", "logits", "unread_recompute"}
CASES = {"default": ["--arch", "paligemma-3b"],
         "batch1": ["--arch", "paligemma-3b", "--batch", "1"]}
HELD = [("default", "False", {"hlo_f32", "lookup_scatter_gather", "tied_table_twice"}, PORT_ONLY),
        ("default", "True", {"hlo_f32", "hlo_reduce_scatter_as_all_reduce", "fsdp_backward_gather",
                             "logits_gradient_gather", "lookup_all_to_all",
                             "lookup_scatter_gather"}, PORT_ONLY),
        ("batch1", "False", {"hlo_f32", "tied_table_twice"}, PORT_ONLY | {"text_kv_gathers"}),
        ("batch1", "True", {"hlo_f32"}, PORT_ONLY | {"text_kv_gathers", "weights_gathered"})]
_COMPARED = {}


@pytest.mark.parametrize("case,fsdp,terms,port_only", HELD,
                         ids=[f"{c}-{'fsdp' if f == 'True' else 'tp'}" for c, f, _, _ in HELD])
def test_per_device_plus_named_terms_equal_the_reference_hlo(case, fsdp, terms, port_only):
    if case not in _COMPARED:             # one reference compile a shape, FSDP off and on
        _COMPARED[case] = G.compare(CASES[case])
    ref, ours = _COMPARED[case]
    G.hold(ref[fsdp], ours[fsdp], terms, port_only)
