"""Host tools (counterpart of `rvc_tpu/tools`): model blending, inspection,
conversion and audio analysis (`model_tools`), training-curve plots
(`plot_logs`)."""
