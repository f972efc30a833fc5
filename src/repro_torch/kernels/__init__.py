"""Hand-written Hopper kernels of the port, one module per TPU kernel of
`repro.kernels` (`rmsnorm`, `flash_attention`, `reshard_pack`, `bucket`,
`ssd_scan`),
each with its plain PyTorch version in `kernels.ref` and its device
dispatch and launch counter in `kernels.mode`. The CUDA sources live in `csrc/` and are
built by `kernels.build` at first use."""
