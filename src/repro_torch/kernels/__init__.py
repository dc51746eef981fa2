"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it (``knn``: flat brute force; ``frontier``: the fused
frontier walk; ``sieve``: the P-Orth sieve's counting sort; ``bbox``:
masked per-row bounding boxes; ``morton``: quantize and bit-interleave
into Z-curve codes; ``flash_attn``: online-softmax attention for the LM
serving path; ``selective_scan`` and ``wkv``: the Mamba and RWKV6
recurrences, which replace no TPU kernel). Sources live in ``repro_torch/csrc``;
:mod:`.build` compiles them with ``nvcc`` at first use."""
