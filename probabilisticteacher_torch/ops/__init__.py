"""Box, anchor, ROIAlign and NMS operations, and the CUDA kernel wrappers."""
