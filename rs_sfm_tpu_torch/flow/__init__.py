"""Dense optical flow (pyramidal variational, with the forward-backward
occlusion test) and the model-feedback pass."""
