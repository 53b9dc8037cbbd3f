"""Hand-written CUDA kernels of the port, each beside its plain version.

``flash_attention`` (prefill, ``forward``, training),
``flash_attention_backward`` (training; tied to the forward by the
``FlashAttention`` autograd function) and ``paged_attention`` (decode). A
wrapper takes its plain version only for tensors that lie on
the CPU; for CUDA tensors it launches its kernel or raises. Each wrapper
counts its launches in a plain integer attribute, ``<wrapper>.launches``.
"""
