"""Few-shot demonstrations of the KiRAG prompts (the JAX package's data,
copied so that the port imports nothing of it)."""
