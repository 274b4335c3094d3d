"""DAKC k-mer counting in PyTorch, with hand-written CUDA kernels for Hopper.

The counterpart of the JAX package `repro`: the same counting pipeline,
the same per-PE results and statistics, with the processing elements (PEs)
held as a leading tensor dimension on one device. Entry point:
`repro_torch.core.fabsp.count_kmers`.
"""
