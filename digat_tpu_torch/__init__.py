"""digat_tpu_torch: the PyTorch/CUDA port of digat_tpu for one NVIDIA H100.

This slice serves the production MSA-DIGAT model through the two-stage
cached scorer: stage 1 encodes every unique news title once (hand-written
CUDA kernel `ops.msa_encoder`) and caches the initial news context c_n0;
stage 2 runs the DIGAT graph encoder per impression item, each interactive
GAT layer as one call of the hand-written kernel `ops.gat_layer`.

The package imports torch and numpy only, never jax or digat_tpu. Entry
points (`models.model.Model`, `eval.scorer.CachedScorer`,
`eval.scorer.compute_scores`) run on CUDA unless the caller passes
`device="cpu"`; with no device and no CUDA they raise.
"""

__version__ = "0.1.0"
