"""Host tools (counterpart of `rvc_tpu/tools`): model blending, inspection,
conversion and audio analysis (`model_tools`), training-curve plots
(`plot_logs`), the model and prerequisite downloader (`download`) and the
edge-tts front end (`tts`)."""
