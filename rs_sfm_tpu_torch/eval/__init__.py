"""Error metrics of the estimate against a ground truth."""
