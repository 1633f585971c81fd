"""The dry run's per-device collectives of the MoE family (qwen2-moe-a2.7b,
2 layers) held to the reference's compiled HLO (``torch_hlo_gate.hold``):
at the tool's default shape (4 x 64 on (2, 4)), FSDP off and on, with
XLA's partition of the sort-based dispatch (``roofline._moe_dispatch``:
the expert buffers and dispatched rows all-reduced and permuted, the
router's probabilities gathered) in place of the port's per-piece expert
gathers, and at ``--batch 1`` (its positions over "data") without FSDP.
With FSDP at batch 1 XLA moves the tokens to the experts by all-to-all
(530,841,600 B), which ROADMAP's queue 3 lists.
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_hlo_gate as G  # noqa: E402

PORT_ONLY = {"column_outputs", "row_input_gradients", "logits", "moe_exchange",
             "expert_gathers", "unread_recompute"}
CASES = {"default": ["--arch", "qwen2-moe-a2.7b"],
         "batch1": ["--arch", "qwen2-moe-a2.7b", "--batch", "1"]}
HELD = [("default", "False", {"hlo_f32", "lookup_scatter_gather"}, PORT_ONLY),
        ("default", "True", {"hlo_f32", "hlo_reduce_scatter_as_all_reduce", "fsdp_backward_gather",
                             "lookup_gradient_in_place", "lookup_scatter_gather"}, PORT_ONLY),
        ("batch1", "False", {"hlo_f32", "hlo_reduce_scatter_as_all_reduce"}, PORT_ONLY)]
_COMPARED = {}


@pytest.mark.parametrize("case,fsdp,terms,port_only", HELD,
                         ids=[f"{c}-{'fsdp' if f == 'True' else 'tp'}" for c, f, _, _ in HELD])
def test_per_device_plus_named_terms_equal_the_reference_hlo(case, fsdp, terms, port_only):
    if case not in _COMPARED:             # one reference compile a shape, FSDP off and on
        _COMPARED[case] = G.compare(CASES[case])
    ref, ours = _COMPARED[case]
    G.hold(ref[fsdp], ours[fsdp], terms, port_only)
