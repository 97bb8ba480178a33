"""Shared memory of an NVIDIA H100 (sm_90), which the layouts of the
TMA-fed streaming kernels (``stream_cg_coef.coef_layout``,
``stream_cg_sym.sym_layout``, ``stream_cg_real.real_layout``) fit their
rings into.

The kernels keep no copy of these numbers: a launch that asks for more than
the card gives a block is refused by the CUDA runtime, and the wrapper
raises.
"""

SM_SHARED = 233472          # shared memory of one SM, bytes
BLOCK_SHARED = 232448       # the most one block may take, static included
BLOCK_RESERVED = 1024       # the runtime's own share of each block
STATIC_SHARED = 2048        # the streaming kernels' static shared memory,
                            # at most (each kernel's own is below it)
