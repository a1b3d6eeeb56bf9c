"""The evaluation layer: metrics, LPIPS, the FID Inception and the evaluator."""
