"""Flash attention: the CUDA kernel, its plain version and the model-layout entry point."""
