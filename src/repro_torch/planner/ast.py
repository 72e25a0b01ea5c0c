"""Logical layer of the recursive-query planner: a ``WITH RECURSIVE``-shaped
AST and a parser for a minimal SQL dialect (§5.1 Listings 1.1–1.3).

The AST captures exactly the logical degrees of freedom the paper studies:
the seed predicate (which endpoint equals the root), the recursive join
direction, the carried columns, the depth bound, UNION vs UNION ALL, and an
optional outer depth filter.  Everything *physical* — positional vs tuple vs
row pipelines, early vs late materialization, the Exp-3 rewrite, sparse vs
dense frontiers — is deliberately absent: those are the optimizer's choices
(:mod:`repro_torch.planner.optimize`), not the query's.

Dialect grammar (see docs/planner.md for the full write-up)::

    query  := WITH RECURSIVE cte [ '(' names ')' ] AS '(' seed
              UNION [ALL] rec ')' outer [';']
    seed   := SELECT items FROM edges [[AS] e] WHERE col '=' root
    rec    := SELECT items FROM edges [[AS] e] JOIN cte [[AS] t]
              ON joincond [WHERE cte.depth ('<'|'<=') INT]
    outer  := SELECT items FROM cte [[AS] t]
              [JOIN edges [[AS] e] ON t.id '=' e.id]
              [WHERE depth ('<'|'<=') INT]
    joincond := colref '=' colref [OR colref '=' colref]
    items  := item (',' item)* ; item := '*' | alias'.*' | colref
              | INT | colref '+' (INT | colref)
              | agg '(' colref '*' colref ')' ; agg := SUM|MIN|MAX|MUL
    root   := INT | ':' name | '?'

Because ``from`` is also a keyword, the edge columns are written quoted
(``"from"``, ``"to"``) or alias-qualified (``e.from``) — bare ``from`` in a
select list is always the keyword.  A literal ``0`` seed item and the
``t.depth + 1`` recursive item denote the depth counter; the counter column
must be named ``depth``.

Weighted accumulators (the semiring workloads, docs/workloads.md):

* ``t.depth + e.w`` in the recursive term generalizes the depth counter to
  a (min, +) distance — the query becomes weighted SSSP
  (``workload='shortest_path'``) over the edge-weight column ``w``;
* ``SUM(t.value * e.qty)`` (or MIN/MAX/MUL) declares a path-aggregation
  accumulator (``workload='aggregate_sum'`` …) over ``qty``; the
  accumulator column must be named ``value`` and is seeded with the
  literal ``1`` (the ⊗-identity) in the seed select.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

__all__ = ["RecursiveCTE", "LogicalQuery", "ParseError", "parse",
           "normalize", "paper_listing", "weighted_listing", "EDGE_COLS"]

EDGE_COLS = ("id", "from", "to", "name")

_PAYLOAD_RE = re.compile(r"column(\d+)$")


class ParseError(ValueError):
    """Raised when a query string falls outside the minimal dialect."""


@dataclasses.dataclass(frozen=True)
class RecursiveCTE:
    """The parsed logical query (one paper-listing-shaped CTE)."""

    cte_name: str
    carried_cols: Tuple[str, ...]      # CTE columns (depth counter excluded)
    carries_depth: bool                # CTE carries a depth counter column
    seed_col: str                      # 'from' | 'to' — the seed predicate
    root: Optional[int]                # literal root, or None for :param / ?
    union_all: bool                    # UNION ALL vs UNION (distinct)
    direction: str                     # 'outbound' | 'inbound' | 'both'
    max_depth: Optional[int]           # recursion bound (None = unbounded)
    outer_cols: Tuple[str, ...]        # outer select list ('*' kept literal)
    depth_filter: Optional[int]        # outer WHERE depth <= k (inclusive)
    top_level_join: bool               # Listing-1.3 shape: outer join on id
    workload: str = "reach"            # semiring workload (from accumulator)
    weight_col: Optional[str] = None   # ⊗-weight column (weighted only)


@dataclasses.dataclass(frozen=True)
class LogicalQuery:
    """The normalized query the optimizer plans: AST folded onto the
    existing :class:`~repro_torch.core.engine.RecursiveQuery` axes, with
    the depth filter pushed down into the recursion bound."""

    root: Optional[int]
    max_depth: int                     # effective bound after pushdown
    payload_cols: int                  # the paper's N, from the output list
    dedup: bool                        # BFS semantics (False = raw UNION ALL)
    direction: str
    want_cols: Tuple[str, ...]         # value columns the caller asked for
    want_depth: bool                   # expose row depths as a 'depth' column
    union_all: bool                    # as written (pre-canonicalization)
    workload: str = "reach"            # semiring workload
    weight_col: Optional[str] = None   # ⊗-weight column (weighted only)


# ---------------------------------------------------------------------------
# tokenizer + a tiny recursive-descent parser
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r'''
      "(?P<quoted>[^"]*)"
    | (?P<num>\d+)
    | (?P<word>[A-Za-z_][A-Za-z_0-9]*)
    | (?P<punct><=|>=|<>|[(),=<>.*+;?:])
    | (?P<ws>\s+)
    | (?P<bad>.)
''', re.VERBOSE)

_KEYWORDS = {"with", "recursive", "as", "select", "from", "where", "union",
             "all", "join", "on", "or", "and"}


class _Tok:
    __slots__ = ("kind", "text")

    def __init__(self, kind: str, text: str):
        self.kind = kind        # 'kw' | 'name' | 'num' | 'punct' | 'qname'
        self.text = text

    def __repr__(self):
        return f"{self.kind}:{self.text}"


def _tokenize(sql: str) -> list[_Tok]:
    toks = []
    for m in _TOKEN_RE.finditer(sql):
        if m.lastgroup == "ws":
            continue
        if m.lastgroup == "bad":
            raise ParseError(f"unexpected character {m.group()!r} in query")
        if m.lastgroup == "quoted":
            toks.append(_Tok("qname", m.group("quoted").lower()))
        elif m.lastgroup == "num":
            toks.append(_Tok("num", m.group()))
        elif m.lastgroup == "word":
            w = m.group().lower()
            toks.append(_Tok("kw" if w in _KEYWORDS else "name", w))
        else:
            toks.append(_Tok("punct", m.group()))
    return toks


class _Parser:
    def __init__(self, sql: str):
        self.toks = _tokenize(sql)
        self.i = 0

    # -- cursor helpers ---------------------------------------------------
    def _peek(self, k: int = 0) -> Optional[_Tok]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def _next(self) -> _Tok:
        t = self._peek()
        if t is None:
            raise ParseError("unexpected end of query")
        self.i += 1
        return t

    def _accept(self, kind: str, text: Optional[str] = None) -> bool:
        t = self._peek()
        if t is not None and t.kind == kind and (text is None
                                                 or t.text == text):
            self.i += 1
            return True
        return False

    def _expect(self, kind: str, text: Optional[str] = None) -> _Tok:
        t = self._peek()
        if t is None or t.kind != kind or (text is not None
                                           and t.text != text):
            want = text or kind
            raise ParseError(f"expected {want!r}, got {t!r}")
        return self._next()

    def _kw(self, *words: str) -> None:
        for w in words:
            self._expect("kw", w)

    def _name(self) -> str:
        t = self._next()
        if t.kind not in ("name", "qname", "kw"):
            raise ParseError(f"expected identifier, got {t!r}")
        return t.text

    # -- grammar ----------------------------------------------------------
    def parse(self) -> RecursiveCTE:
        self._kw("with", "recursive")
        cte_name = self._name()
        named_cols: Optional[list[str]] = None
        if self._accept("punct", "("):
            named_cols = [self._ident_only()]
            while self._accept("punct", ","):
                named_cols.append(self._ident_only())
            self._expect("punct", ")")
        self._kw("as")
        self._expect("punct", "(")
        seed_items, seed_alias = self._select_from()
        self._kw("where")
        seed_col, root = self._seed_predicate(seed_alias)
        self._kw("union")
        union_all = self._accept("kw", "all")
        rec = self._recursive_term(cte_name)
        self._expect("punct", ")")
        outer_cols, top_join, depth_filter = self._outer(cte_name)
        self._accept("punct", ";")
        if self._peek() is not None:
            raise ParseError(f"trailing tokens after query: {self._peek()!r}")

        carried, carries_depth = self._carried(named_cols, seed_items)
        direction = rec["direction"]
        if seed_col not in ("from", "to"):
            raise ParseError(f"seed predicate must filter \"from\" or "
                             f"\"to\", got {seed_col!r}")
        expect_seed = {"outbound": "from", "inbound": "to"}.get(direction)
        if expect_seed is not None and seed_col != expect_seed:
            raise ParseError(
                f"seed predicate on {seed_col!r} contradicts the "
                f"{direction} recursive join (expected {expect_seed!r})")
        if rec["workload"].startswith("aggregate_") and not any(
                item[0] == "value_seed" for item in seed_items):
            raise ParseError("an aggregation accumulator needs the literal "
                             "value seed 1 in the seed select")
        return RecursiveCTE(
            cte_name=cte_name, carried_cols=tuple(carried),
            carries_depth=carries_depth, seed_col=seed_col, root=root,
            union_all=union_all, direction=direction,
            max_depth=rec["max_depth"], outer_cols=tuple(outer_cols),
            depth_filter=depth_filter, top_level_join=top_join,
            workload=rec["workload"], weight_col=rec["weight_col"])

    def _ident_only(self) -> str:
        t = self._next()
        if t.kind not in ("name", "qname") and not (t.kind == "kw"
                                                    and t.text in ("from",
                                                                   "to")):
            raise ParseError(f"expected column name, got {t!r}")
        return t.text

    def _select_from(self) -> tuple[list, Optional[str]]:
        """SELECT items FROM <table> [[AS] alias] — returns (items, alias)."""
        self._kw("select")
        items = self._select_items()
        self._kw("from")
        self._name()                       # table (always the edge table)
        alias = self._opt_alias()
        return items, alias

    def _opt_alias(self) -> Optional[str]:
        if self._accept("kw", "as"):
            return self._name()
        t = self._peek()
        if t is not None and t.kind == "name":
            return self._next().text
        return None

    _AGG_FNS = ("sum", "min", "max", "mul")

    def _select_items(self) -> list:
        """Items are ('col', name) | ('star', alias|None) | ('depth0',)
        | ('value_seed',) | ('depth+1',) | ('depth+w', col)
        | ('agg', fn, col).  Alias qualifiers are stripped."""
        items = [self._select_item()]
        while self._accept("punct", ","):
            items.append(self._select_item())
        return items

    def _select_item(self):
        if self._accept("punct", "*"):
            return ("star", None)
        t = self._peek()
        if t is not None and t.kind == "num":
            self._next()
            if t.text == "0":
                return ("depth0",)
            if t.text == "1":
                return ("value_seed",)      # ⊗-identity seed for the value
            raise ParseError("the only literal select items are the depth "
                             "seed 0 and the value seed 1")
        nxt = self._peek(1)
        if (t is not None and t.kind == "name" and t.text in self._AGG_FNS
                and nxt is not None and nxt.kind == "punct"
                and nxt.text == "("):
            return self._agg_item()
        name = self._colref()
        nxt = self._peek()
        if nxt is not None and nxt.kind == "punct" and nxt.text == "*":
            # alias '.' '*' was parsed as colref consuming '.'? handled below
            raise ParseError("unexpected '*'")
        if self._accept("punct", "+"):
            if name != "depth":
                raise ParseError("the only arithmetic select items are "
                                 "depth + 1 and depth + <weight column>")
            t = self._peek()
            if t is not None and t.kind == "num":
                one = self._next()
                if one.text != "1":
                    raise ParseError("the depth counter increments by 1; "
                                     "a weight is a column reference")
                return ("depth+1",)
            return ("depth+w", self._colref())
        return ("col", name)

    def _agg_item(self):
        """``AGG(t.value * e.w)`` — a path-aggregation accumulator."""
        fn = self._next().text
        self._expect("punct", "(")
        left = self._colref()
        if left != "value":
            raise ParseError(f"the aggregation accumulator must be named "
                             f"'value', got {left!r}")
        self._expect("punct", "*")
        weight = self._colref()
        self._expect("punct", ")")
        return ("agg", fn, weight)

    def _colref(self) -> str:
        """[alias '.'] column — returns the bare column name; ``alias.*``
        returns '*'."""
        first = self._name()
        if self._accept("punct", "."):
            if self._accept("punct", "*"):
                return "*"
            return self._ident_only()
        return first

    def _seed_predicate(self, alias: Optional[str]) -> tuple[str, Optional[int]]:
        col = self._colref()
        self._expect("punct", "=")
        t = self._next()
        if t.kind == "num":
            return col, int(t.text)
        if t.kind == "punct" and t.text == "?":
            return col, None
        if t.kind == "punct" and t.text == ":":
            self._name()
            return col, None
        raise ParseError(f"seed root must be an integer, '?' or ':name', "
                         f"got {t!r}")

    def _recursive_term(self, cte_name: str) -> dict:
        self._kw("select")
        items = self._select_items()       # carried cols re-checked via CTE
        workload, weight_col = "reach", None
        for item in items:
            if item[0] == "depth+w":
                w, c = "shortest_path", item[1]
            elif item[0] == "agg":
                w, c = "aggregate_" + item[1], item[2]
            else:
                continue
            if workload != "reach":
                raise ParseError("at most one weighted accumulator per "
                                 "recursive term")
            workload, weight_col = w, c
        self._kw("from")
        first = self._name()
        first_alias = self._opt_alias()
        self._kw("join")
        second = self._name()
        second_alias = self._opt_alias()
        self._kw("on")
        # which side is the CTE?
        names = {first: first_alias or first, second: second_alias or second}
        if cte_name not in names:
            raise ParseError(f"recursive term must join the CTE "
                             f"{cte_name!r}; joined {first!r} and {second!r}")
        cte_alias = names[cte_name]
        edge_alias = next(a for n, a in names.items() if n != cte_name)
        direction = self._join_condition(cte_alias, edge_alias)
        max_depth = None
        if self._accept("kw", "where"):
            max_depth = self._depth_bound()
        return {"direction": direction, "max_depth": max_depth,
                "workload": workload, "weight_col": weight_col}

    def _qualified(self) -> tuple[Optional[str], str]:
        first = self._name()
        if self._accept("punct", "."):
            return first, self._ident_only()
        return None, first

    def _join_condition(self, cte_alias: str, edge_alias: str) -> str:
        def one_eq() -> tuple[str, str]:
            """Returns (edge_col, cte_col) regardless of operand order."""
            q1, c1 = self._qualified()
            self._expect("punct", "=")
            q2, c2 = self._qualified()
            sides = {q1: c1, q2: c2}
            if set(sides) != {cte_alias, edge_alias}:
                raise ParseError(
                    f"join condition must relate {edge_alias!r} to "
                    f"{cte_alias!r}, got {q1!r} = {q2!r}")
            return sides[edge_alias], sides[cte_alias]

        ec, cc = one_eq()
        legs = {(ec, cc)}
        if self._accept("kw", "or"):
            legs.add(one_eq())
        if legs == {("from", "to")}:
            return "outbound"
        if legs == {("to", "from")}:
            return "inbound"
        if legs == {("from", "to"), ("to", "from")}:
            return "both"
        raise ParseError(f"unsupported join condition {sorted(legs)!r}; "
                         "expected e.from = cte.to (outbound), "
                         "e.to = cte.from (inbound), or both OR-ed")

    def _depth_bound(self) -> int:
        col = self._colref()
        if col != "depth":
            raise ParseError(f"only depth bounds are supported in the "
                             f"recursive WHERE, got {col!r}")
        op = self._expect("punct")
        if op.text not in ("<", "<="):
            raise ParseError(f"depth bound operator must be < or <=, "
                             f"got {op.text!r}")
        k = int(self._expect("num").text)
        # rows produced satisfy depth <= bound: '< k' caps depth at k
        # (seed is depth 0 and each recursion adds 1), '<= k' at k + 1.
        return k if op.text == "<" else k + 1

    def _outer(self, cte_name: str) -> tuple[list[str], bool, Optional[int]]:
        self._kw("select")
        raw = self._select_items()
        self._kw("from")
        first = self._name()
        first_alias = self._opt_alias()
        top_join = False
        if first != cte_name:
            raise ParseError(f"outer SELECT must read the CTE "
                             f"{cte_name!r}, got {first!r}")
        if self._accept("kw", "join"):
            second = self._name()
            second_alias = self._opt_alias()
            self._kw("on")
            q1, c1 = self._qualified()
            self._expect("punct", "=")
            q2, c2 = self._qualified()
            aliases = {first_alias or first, second_alias or second}
            if (c1, c2) != ("id", "id") or {q1, q2} != aliases:
                raise ParseError("the only supported top-level join is "
                                 "ON cte.id = edges.id")
            top_join = True
        depth_filter = None
        if self._accept("kw", "where"):
            col = self._colref()
            if col != "depth":
                raise ParseError(f"only depth filters are supported in the "
                                 f"outer WHERE, got {col!r}")
            op = self._expect("punct")
            if op.text not in ("<", "<="):
                raise ParseError("outer depth filter must use < or <=")
            k = int(self._expect("num").text)
            depth_filter = k if op.text == "<=" else k - 1
        cols = []
        for item in raw:
            if item[0] == "star":
                cols.append("*")
            elif item[0] == "col":
                cols.append(item[1])
            else:
                raise ParseError("outer select supports only columns "
                                 "and *")
        return cols, top_join, depth_filter

    @staticmethod
    def _carried(named_cols: Optional[list[str]],
                 seed_items: list) -> tuple[list[str], bool]:
        if named_cols is not None:
            # 'value' is the synthesized accumulator column, not a carried
            # edge column
            carried = [c for c in named_cols if c not in ("depth", "value")]
            return carried, "depth" in named_cols
        carried, depth = [], False
        for item in seed_items:
            if item[0] == "col":
                carried.append(item[1])
            elif item[0] in ("depth0", "depth+1"):
                depth = True
            elif item[0] == "value_seed":
                pass                        # accumulator column, not carried
            else:
                raise ParseError("SELECT * is not allowed inside the CTE; "
                                 "name the carried columns")
        return carried, depth


def parse(sql: str) -> RecursiveCTE:
    """Parse one minimal-dialect ``WITH RECURSIVE`` query into the AST."""
    return _Parser(sql).parse()


# ---------------------------------------------------------------------------
# normalization: AST -> LogicalQuery on the engine's RecursiveQuery axes
# ---------------------------------------------------------------------------

def _dataset_payloads(ds) -> int:
    n = 0
    for name in ds.table.names:
        m = _PAYLOAD_RE.match(name)
        if m:
            n = max(n, int(m.group(1)))
    return n


def normalize(ast: RecursiveCTE, ds, *, root=None,
              default_max_depth: Optional[int] = None) -> LogicalQuery:
    """Fold the AST onto the engine's query axes.

    * the outer depth filter is PUSHED DOWN into the recursion bound (the
      row-depth tags make the pushdown exact, so no post-filter remains);
    * ``UNION ALL`` maps to ``dedup=False`` — except on a forest, where raw
      UNION ALL walks and BFS coincide and the planner canonicalizes to the
      (cheaper, more widely supported) dedup form;
    * the paper's N follows from the columns the caller can observe, not
      from the CTE's carry list — carrying less is the optimizer's job
      (the Exp-3 rewrite), not a different logical query.
    """
    if root is None:
        root = ast.root
    available = _dataset_payloads(ds)

    def payload_n(cols) -> int:
        """The paper's N: the HIGHEST payload index referenced (the engine
        materializes the contiguous prefix column1..columnN)."""
        return max((int(m.group(1)) for c in cols
                    for m in [_PAYLOAD_RE.match(c)] if m), default=0)

    # output column set ('*' expands to the joined edge row for the
    # Listing-1.3 shape, to the carried columns otherwise; an explicit
    # select list is honored either way)
    if "*" in ast.outer_cols:
        want = (list(EDGE_COLS) + [f"column{i + 1}"
                                   for i in range(available)]
                if ast.top_level_join else list(ast.carried_cols))
        explicit = [c for c in ast.outer_cols if c != "*"]
        want += [c for c in explicit if c not in want]
    else:
        want = list(ast.outer_cols)
    want_depth = "depth" in want or (
        "*" in ast.outer_cols and not ast.top_level_join
        and ast.carries_depth)
    # 'depth' maps to row_depths; 'value' to the semiring value plane the
    # physical choice attaches — neither is a stored edge column
    want = [c for c in want if c not in ("depth", "value")]
    # N covers every referenced payload, including explicit outer extras
    payloads = payload_n(want)

    known = set(ds.table.names)
    for c in list(ast.carried_cols) + want:
        if c not in known:
            raise ParseError(f"unknown column {c!r}; the edge table has "
                             f"{sorted(known)}")
    workload = getattr(ast, "workload", "reach")
    weight_col = getattr(ast, "weight_col", None)
    if workload != "reach" and weight_col not in known:
        raise ParseError(f"unknown weight column {weight_col!r}; the edge "
                         f"table has {sorted(known)}")

    stats = ds.stats(ast.direction)
    dedup = (not ast.union_all) or stats.is_forest

    max_depth = ast.max_depth
    if max_depth is None:
        if not dedup:
            raise ParseError(
                "UNION ALL on a non-forest graph needs an explicit depth "
                "bound (WHERE depth < k) — the walk does not terminate")
        max_depth = (default_max_depth if default_max_depth is not None
                     else ds.num_vertices)
    if ast.depth_filter is not None:
        if ast.depth_filter < 0:
            raise ParseError("empty depth filter (depth < 0)")
        max_depth = min(max_depth, ast.depth_filter)

    return LogicalQuery(
        root=root, max_depth=max_depth, payload_cols=payloads, dedup=dedup,
        direction=ast.direction, want_cols=tuple(want),
        want_depth=want_depth, union_all=ast.union_all,
        workload=workload, weight_col=weight_col)


# ---------------------------------------------------------------------------
# the three paper listings, as dialect strings
# ---------------------------------------------------------------------------

def paper_listing(n: int, *, root: int = 0, depth: int = 10,
                  payload_cols: int = 0) -> str:
    """§5.1 Listings 1.1 (traversal columns), 1.2 (payloads carried through
    the recursion) and 1.3 (the Exp-3 rewrite shape: slim CTE + one
    top-level join)."""
    pays = [f"column{i + 1}" for i in range(payload_cols)]
    if n == 1:
        cols = ["id", '"from"', '"to"', "name"]
    elif n == 2:
        cols = ["id", '"from"', '"to"', "name"] + pays
    elif n == 3:
        cols = ["id", '"to"']
    else:
        raise ValueError(f"no paper listing {n}; expected 1, 2 or 3")
    names = ", ".join(c.strip('"') for c in cols)
    seed = ", ".join(cols)
    rec = ", ".join(f"e.{c}" for c in cols)
    body = (f"WITH RECURSIVE t ({names}, depth) AS (\n"
            f"  SELECT {seed}, 0 FROM edges WHERE \"from\" = {root}\n"
            f"  UNION ALL\n"
            f"  SELECT {rec}, t.depth + 1\n"
            f"  FROM edges AS e JOIN t ON e.\"from\" = t.\"to\"\n"
            f"  WHERE t.depth < {depth}\n"
            f")\n")
    if n == 3:
        return body + "SELECT e.* FROM t JOIN edges AS e ON t.id = e.id"
    return body + "SELECT * FROM t"


def weighted_listing(workload: str, *, root: int = 0, depth: int = 10,
                     weight_col: str = "w") -> str:
    """The weighted-workload query shapes (docs/workloads.md): SSSP spells
    the accumulator as a generalized depth counter (``t.depth + e.w``);
    the aggregations carry an explicit ``value`` column seeded with the
    ⊗-identity ``1`` and folded by ``AGG(t.value * e.w)``."""
    if workload == "shortest_path":
        return (f'WITH RECURSIVE t ("to", depth) AS (\n'
                f'  SELECT "to", 0 FROM edges WHERE "from" = {root}\n'
                f'  UNION\n'
                f'  SELECT e."to", t.depth + e.{weight_col}\n'
                f'  FROM edges AS e JOIN t ON e."from" = t."to"\n'
                f'  WHERE t.depth < {depth}\n'
                f')\nSELECT * FROM t')
    if workload.startswith("aggregate_"):
        fn = workload[len("aggregate_"):].upper()
        if workload not in ("aggregate_sum", "aggregate_min",
                            "aggregate_max", "aggregate_mul"):
            raise ValueError(f"no weighted listing for {workload!r}")
        return (f'WITH RECURSIVE t ("to", value, depth) AS (\n'
                f'  SELECT "to", 1, 0 FROM edges WHERE "from" = {root}\n'
                f'  UNION ALL\n'
                f'  SELECT e."to", {fn}(t.value * e.{weight_col}), '
                f't.depth + 1\n'
                f'  FROM edges AS e JOIN t ON e."from" = t."to"\n'
                f'  WHERE t.depth < {depth}\n'
                f')\nSELECT * FROM t')
    raise ValueError(f"no weighted listing for {workload!r}")
