"""Training (counterpart of `rvc_tpu/train`): the losses, the data
pipeline, the GAN train step with its optimizer, schedulers, overtraining
detection, and the trainer with its checkpoints, on one card."""
