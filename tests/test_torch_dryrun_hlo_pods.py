"""The dry run's per-device collectives on a mesh with pods, (pod, data,
model), held to the reference's compiled HLO (``torch_hlo_gate.hold``),
FSDP off and on, 2 layers, 64 positions a row:

- gemma2-2b on (2, 2, 2), 8 rows: an FSDP shard's gradient all-reduced
  over "pod" after its reduce-scatter over "data", the tied table's
  twice; the lookup's gradient reduced in two stages without FSDP;
- qwen2-moe-a2.7b on (2, 2, 2), 8 rows ("data" divides its experts): the
  dispatch gathers the tokens over "pod" and no expert gradient is
  reduced over "pod";
- qwen2-moe-a2.7b on (2, 8, 2), 16 rows ("data" does not divide its
  experts), as its production multi-pod placement does.
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_hlo_gate as G  # noqa: E402

DENSE = {"column_outputs", "row_input_gradients", "logits"}
MOE = DENSE | {"moe_exchange", "expert_gathers", "unread_recompute", "replicated_gradients"}
MOE_TP = {"hlo_f32", "lookup_gradient_in_stages", "lookup_scatter_gather"}
MOE_FSDP = {"hlo_f32", "hlo_reduce_scatter_as_all_reduce", "fsdp_backward_gather",
            "lookup_gradient_in_place", "lookup_scatter_gather"}
CASES = {"gemma2": ["--arch", "gemma2-2b", "--batch", "8", "--mesh", "2,2,2"],
         "moe_divided": ["--arch", "qwen2-moe-a2.7b", "--batch", "8", "--mesh", "2,2,2"],
         "moe_whole": ["--arch", "qwen2-moe-a2.7b", "--batch", "16", "--mesh", "2,8,2"]}
HELD = [("gemma2", "False", {"hlo_f32", "lookup_gradient_in_stages", "lookup_scatter_gather",
                             "tied_table_twice"}, DENSE),
        ("gemma2", "True", {"hlo_f32", "hlo_reduce_scatter_as_all_reduce", "fsdp_backward_gather",
                            "lookup_all_to_all", "lookup_scatter_gather", "tied_table_twice"},
         DENSE),
        ("moe_divided", "False", MOE_TP, MOE),
        ("moe_divided", "True", MOE_FSDP, MOE),
        ("moe_whole", "False", MOE_TP, MOE),
        ("moe_whole", "True", MOE_FSDP, MOE)]
_COMPARED = {}


@pytest.mark.parametrize("case,fsdp,terms,port_only", HELD,
                         ids=[f"{c}-{'fsdp' if f == 'True' else 'tp'}" for c, f, _, _ in HELD])
def test_per_device_plus_named_terms_equal_the_reference_hlo(case, fsdp, terms, port_only):
    if case not in _COMPARED:             # one reference compile a shape, FSDP off and on
        _COMPARED[case] = G.compare(CASES[case])
    ref, ours = _COMPARED[case]
    G.hold(ref[fsdp], ours[fsdp], terms, port_only)
