"""The paper-dataflow conv: planner, accountant, op and CUDA kernel."""
