"""PyTorch / CUDA port of the WSSL system, slice by slice, beside the JAX
package ``repro`` (the reference).  It imports ``torch`` and numpy, never
``jax`` and nothing of ``repro``.  So far it holds the serving path of a
dense global-attention model (Gemma-2B) with hand-written CUDA kernels for
prefill (flash attention) and paged decode attention; see ROADMAP.md for
what comes next.
"""
