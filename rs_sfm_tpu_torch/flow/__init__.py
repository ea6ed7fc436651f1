"""Dense optical flow (pyramidal variational, with the forward-backward
occlusion test), the model-feedback pass, the flow self-check and the flow
visualization."""
