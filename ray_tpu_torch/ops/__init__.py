"""Tensor primitives: normalisation, rotary embedding, activations, attention."""
