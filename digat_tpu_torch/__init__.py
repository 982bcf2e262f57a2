"""digat_tpu_torch: the PyTorch/CUDA port of digat_tpu for one NVIDIA H100.

It trains and serves the DIGAT family (the production MSA-DIGAT, its five
graph-encoder ablations with the vanilla GAT layer, and the CNN news
encoder: `config.Config.graph_encoder`, `news_encoder`), and the NRMS family
(NRMS and NRMS-SA, `models.nrms.NRMSModel`: both towers' masked multi-head
attention as a hand-written kernel pair forward and backward,
`ops.msa_attention`; served by `eval.scorer.NRMSCachedScorer`):

  * training (`train.trainer.Trainer`, `train.train_step.train_step`): the
    listwise loss over unique-title dedup batches, Adam with a global-norm
    clip; the news encoder runs as hand-written CUDA kernels forward
    (`ops.msa_encoder`, word dropout inside) and backward, the Eq. (8) GAT
    scores as kernels forward and backward (`ops.gat_scores`), the
    word-embedding gradient as a sorted segment sum (`ops.emb_grad`), and
    every dropout mask is drawn by a Philox kernel (`ops.dropout`);
  * serving (`eval.scorer.CachedScorer`, `eval.scorer.compute_scores`):
    stage 1 encodes every unique news title once and caches the initial
    news context c_n0; stage 2 runs the DIGAT graph encoder per impression
    item, each interactive GAT layer as one call of the kernel
    `ops.gat_layer`;
  * the experiment driver (`cli`, `python -m digat_tpu_torch.cli`): train,
    dev and test modes from MIND-layout TSV files through the data
    pipeline (`data.tokenize`, `data.synthetic`, `data.prepare`,
    `data.sag`, `data.corpus`), with the JAX package's flags, cache names
    and run layout.

`Config.compute_dtype="bfloat16"` runs every model on bf16 compute copies
of the fp32 weights (`models.model.ComputeCopy`), with bf16 instances of
kernels A, A', B, C's forward, A'' and the attention pair.

The package imports torch and numpy only, never jax or digat_tpu. Entry
points (`models.model.Model`, `models.nrms.NRMSModel`, the trainer, the
scorers) run on CUDA unless the caller passes `device="cpu"`; with no
device and no CUDA they raise.
"""

__version__ = "0.5.0"
