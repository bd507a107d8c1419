"""The plain reference the benchmark holds the port against.

Plain PyTorch, written from the published equations of the reference
repository (ConditionalUNet, `v1/model_train_test.py:501-561`; Decoder,
`:242-290`; the ancestral DDPM sampler, `:564-598`), with the serving
operating point of the configuration file (classifier-free guidance, x0
clipping, z-scored latents, uint8 output). It imports nothing of the port
and nothing of the JAX package, and it takes nothing the port made: the
weights come from the benchmark's own seeded generator, and what the port
derives from a request's seed (the starting state, the Philox key, the step
noise) is worked out again here from frozen copies of that arithmetic
(`seeds.py`, `philox.py`).

Precision follows the configuration's `precision` block: the denoiser's
products take operands rounded to the stated type and accumulate in f32
(TF32 off); everything else is f32. The control (`precision="control"`)
computes the same equations one step lower.
"""
