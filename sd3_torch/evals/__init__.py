"""The port's eval path: batch generation (`generate_images`) and FID
(`fid`, `calculate_fid`); JAX counterpart: sd3_tpu/evals/."""
