"""Hand-written CUDA kernels of the port, each beside its plain version.

  p2p.py         K1, the gathered P2P Laplace sum (csrc/p2p.cu)
  p2p_stream.py  K2, the streaming P2P sum over one tile table
                 (csrc/p2p_stream.cu)
  mac.py         K3, the MAC margin of a traversal frontier (csrc/mac.cu)
  attention.py   K4, blocked causal flash attention with GQA and sliding
                 window (csrc/attention.cu)
  rwkv.py        K5, the RWKV6 WKV recurrence over a whole sequence
                 (csrc/wkv.cu)
  build.py       nvcc build into build/repro_torch/ and ctypes loading

Kernels build and load at first use, never when a module is imported.
"""
