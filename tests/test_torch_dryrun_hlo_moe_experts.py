"""The MoE family's per-device collectives held to the reference's compiled
HLO (``torch_hlo_gate.hold``) where its experts or its layers differ from
qwen2-moe-a2.7b at the tool's default shape (``test_torch_dryrun_hlo_moe.py``):

- arctic-480b (2 layers, 4 x 64 on (2, 4), and 8 x 64 on (2, 2, 2), its
  production layout's pods), FSDP off and on: its dense residual MLP
  beside the experts gathers the dispatch's input as a shared MLP does,
  and its last linear is not recomputed;
- qwen2-moe-a2.7b on (8, 2), 8 x 64, FSDP off and on: "data" does not
  divide its 60 experts, so every device holds them whole, runs them on
  the microbatch's tokens gathered and reduces no expert gradient
  (``roofline._experts_whole``); without FSDP the lookup's gradient is
  reduced in two stages (``lookup_gradient_in_stages``);
- qwen2-moe-a2.7b on (4, 2), 4 x 64, with FSDP (its production
  placement).  Without FSDP the dispatch differs there (ROADMAP queue 3).
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_hlo_gate as G  # noqa: E402

PORT_ONLY = {"column_outputs", "row_input_gradients", "logits", "moe_exchange",
             "expert_gathers", "unread_recompute"}
FSDP_TERMS = {"hlo_f32", "hlo_reduce_scatter_as_all_reduce", "fsdp_backward_gather",
              "lookup_gradient_in_place", "lookup_scatter_gather"}
CASES = {"arctic": ["--arch", "arctic-480b"],
         "arctic_pods": ["--arch", "arctic-480b", "--batch", "8", "--mesh", "2,2,2"],
         "experts_whole": ["--arch", "qwen2-moe-a2.7b", "--batch", "8", "--mesh", "8,2"],
         "mesh_4_2": ["--arch", "qwen2-moe-a2.7b", "--batch", "4", "--mesh", "4,2"]}
HELD = [("arctic", "False", {"hlo_f32", "lookup_scatter_gather"}, PORT_ONLY),
        ("arctic", "True", FSDP_TERMS, PORT_ONLY),
        ("arctic_pods", "False", {"hlo_f32", "lookup_gradient_in_stages", "lookup_scatter_gather"},
         PORT_ONLY | {"replicated_gradients"}),
        ("arctic_pods", "True", FSDP_TERMS, PORT_ONLY | {"replicated_gradients"}),
        ("experts_whole", "False",
         {"hlo_f32", "lookup_gradient_in_stages", "lookup_scatter_gather"},
         PORT_ONLY | {"replicated_gradients"}),
        ("experts_whole", "True", FSDP_TERMS, PORT_ONLY | {"replicated_gradients"}),
        ("mesh_4_2", "True", FSDP_TERMS, PORT_ONLY)]
_COMPARED = {}


@pytest.mark.parametrize("case,fsdp,terms,port_only", HELD,
                         ids=[f"{c}-{'fsdp' if f == 'True' else 'tp'}" for c, f, _, _ in HELD])
def test_per_device_plus_named_terms_equal_the_reference_hlo(case, fsdp, terms, port_only):
    if case not in _COMPARED:             # one reference compile a shape, FSDP off and on
        _COMPARED[case] = G.compare(CASES[case])
    ref, ours = _COMPARED[case]
    G.hold(ref[fsdp], ours[fsdp], terms, port_only)
