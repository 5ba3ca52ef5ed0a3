"""PyTorch + CUDA port of Grasp-Any-Region, beside the JAX package
`grasp_any_region_tpu` (the reference it is tested against).

It imports torch and numpy, never jax. The attention kernels of the main
path are CUDA C++ for sm_90a (csrc/), built on first use on a CUDA device;
on CPU tensors every kernel wrapper runs its plain PyTorch version.

Layout mirrors the JAX package:
  core/    configs and their I/O, parameter modules, loader, random init,
           checkpoints
  ops/     norms, rope, pooling, attention references and kernel wrappers
  models/  ViT, projector, replay, Llama decoder, GAR assembly, generation
  data/    the host data path (image processor, prompts, chat template,
           tokenizer, builders), synthetic and packed batches
  serve/   the continuous-batching engine
  train/   the train step, optimizer, LoRA
  cli/     GARRuntime and the caption, relationship and video CLIs
  csrc/    CUDA sources
"""

__version__ = "0.1.0"
