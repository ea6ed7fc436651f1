"""Error metrics of the estimate against a ground truth, the castle truth
gate, the evaluateVelocities harness and the artifact writers."""
