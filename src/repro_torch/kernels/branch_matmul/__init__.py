from .branch_matmul import (branch_matmul, branch_matmul_plain, launches,
                            reset_launches)
from .ops import branch_matmul_op, grouped_branch_matmul, parallel_branches

__all__ = ["branch_matmul", "branch_matmul_op", "branch_matmul_plain",
           "grouped_branch_matmul", "launches", "parallel_branches",
           "reset_launches"]
