"""Hand-written Hopper kernels of the port, each beside its plain version.

paged_attention — one-token GQA decode over the paged KV pool (CUDA C++,
                  ``repro_torch/csrc/paged_attention.cu``: split-K across
                  blocks, 16-byte cp.async page loads through a ring)
flash_attention — blockwise GQA prefill attention, causal / windowed /
                  bidirectional (CUDA C++,
                  ``repro_torch/csrc/flash_attention.cu``: bf16 on the
                  tensor cores, wgmma fed by TMA; f32 on the CUDA cores),
                  and its gradient, ``flash_attention_bwd`` (CUDA C++,
                  ``repro_torch/csrc/flash_attention_bwd.cu``: from the
                  forward's log-sum-exp, delta, dK/dV per key tile, dQ per
                  query tile; bf16 on the tensor cores, wgmma fed by TMA;
                  f32 on the CUDA cores)
"""
