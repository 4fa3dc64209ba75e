"""Binary operators.

Reference parity: `Operator` (`datafusion/expr/src/operator.rs:31-89`).
"""
from __future__ import annotations

import enum


class Op(enum.Enum):
    EQ = "="
    NEQ = "!="
    LT = "<"
    LTEQ = "<="
    GT = ">"
    GTEQ = ">="
    PLUS = "+"
    MINUS = "-"
    MULTIPLY = "*"
    DIVIDE = "/"
    MODULO = "%"
    AND = "AND"
    OR = "OR"
    IS_DISTINCT_FROM = "IS DISTINCT FROM"
    IS_NOT_DISTINCT_FROM = "IS NOT DISTINCT FROM"
    STRING_CONCAT = "||"
    BITWISE_AND = "&"
    BITWISE_OR = "|"
    BITWISE_XOR = "#"
    BITWISE_SHIFT_LEFT = "<<"
    BITWISE_SHIFT_RIGHT = ">>"

    @property
    def is_comparison(self) -> bool:
        return self in (Op.EQ, Op.NEQ, Op.LT, Op.LTEQ, Op.GT, Op.GTEQ,
                        Op.IS_DISTINCT_FROM, Op.IS_NOT_DISTINCT_FROM)

    @property
    def is_logic(self) -> bool:
        return self in (Op.AND, Op.OR)

    @property
    def is_arithmetic(self) -> bool:
        return self in (Op.PLUS, Op.MINUS, Op.MULTIPLY, Op.DIVIDE, Op.MODULO)

    def negate(self):
        """Logical negation of a comparison, or None."""
        m = {Op.EQ: Op.NEQ, Op.NEQ: Op.EQ, Op.LT: Op.GTEQ, Op.LTEQ: Op.GT,
             Op.GT: Op.LTEQ, Op.GTEQ: Op.LT,
             Op.IS_DISTINCT_FROM: Op.IS_NOT_DISTINCT_FROM,
             Op.IS_NOT_DISTINCT_FROM: Op.IS_DISTINCT_FROM}
        return m.get(self)

    def swap(self):
        """Operator after swapping operands, or None."""
        m = {Op.EQ: Op.EQ, Op.NEQ: Op.NEQ, Op.LT: Op.GT, Op.LTEQ: Op.GTEQ,
             Op.GT: Op.LT, Op.GTEQ: Op.LTEQ, Op.PLUS: Op.PLUS,
             Op.MULTIPLY: Op.MULTIPLY, Op.AND: Op.AND, Op.OR: Op.OR}
        return m.get(self)

    def __str__(self):
        return self.value


_FROM_SQL = {
    "=": Op.EQ, "==": Op.EQ, "!=": Op.NEQ, "<>": Op.NEQ,
    "<": Op.LT, "<=": Op.LTEQ, ">": Op.GT, ">=": Op.GTEQ,
    "+": Op.PLUS, "-": Op.MINUS, "*": Op.MULTIPLY, "/": Op.DIVIDE,
    "%": Op.MODULO, "AND": Op.AND, "OR": Op.OR, "||": Op.STRING_CONCAT,
    "<=>": Op.IS_NOT_DISTINCT_FROM,
    "&": Op.BITWISE_AND, "|": Op.BITWISE_OR, "#": Op.BITWISE_XOR,
    "^": Op.BITWISE_XOR,
    "<<": Op.BITWISE_SHIFT_LEFT, ">>": Op.BITWISE_SHIFT_RIGHT,
}


def op_from_sql(text: str) -> Op:
    return _FROM_SQL[text.upper()]
