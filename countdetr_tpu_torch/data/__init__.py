"""Host-side data: bucketed batching, request packing and COCO JSON output."""
