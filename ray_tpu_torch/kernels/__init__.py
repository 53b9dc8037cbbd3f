"""Hand-written CUDA kernels of the port, each beside its plain version.

``flash_attention`` (prefill and ``forward``) and ``paged_attention``
(decode). A wrapper takes its plain version only for tensors that lie on
the CPU; for CUDA tensors it launches its kernel or raises. Each wrapper
counts its launches in a plain integer attribute, ``<wrapper>.launches``.
"""
