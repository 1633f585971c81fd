"""The dry run's per-device collectives of the rwkv family (rwkv6-3b, 2
layers) at the tool's default shape (4 x 64 on (2, 4)) without FSDP, its
production placement (3 B params), held to the reference's compiled HLO
(``torch_hlo_gate.hold``): XLA's layer under the activations' sequence
split (``roofline._rwkv_sequence_split``: the token mixes gathered ahead
of the column splits, the heads all-to-all'd for the WKV scan, the
channel mix's receptance gathered whole and its whole gradient reduced)
in place of the port's per-linear rules; and at 2 microbatches (8 x 64),
each microbatch's gradients reduced apart, in f32.  With FSDP, and the
hybrid family, ROADMAP's queue 3 lists what remains.
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_hlo_gate as G  # noqa: E402

PORT_ONLY = {"column_outputs", "row_input_gradients", "logits", "rwkv_layers"}


def test_per_device_plus_named_terms_equal_the_reference_hlo():
    ref, ours = G.compare(["--arch", "rwkv6-3b"])
    G.hold(ref["False"], ours["False"], {"hlo_f32", "lookup_scatter_gather"}, PORT_ONLY)


def test_per_device_at_two_microbatches_equals_the_reference_hlo():
    ref, ours = G.compare(["--arch", "rwkv6-3b", "--batch", "8", "--microbatches", "2"])
    G.hold(ref["False"], ours["False"], {"hlo_f32", "lookup_scatter_gather"}, PORT_ONLY)
