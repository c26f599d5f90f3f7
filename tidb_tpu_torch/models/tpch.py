"""TPC-H lineitem for the port (ref: tidb_tpu/models/tpch.py).

* `LINEITEM`: the lineitem schema as the reference's DDL builds it
  (tpch.py LINEITEM_DDL), hidden `_tidb_rowid` handle column included;
* `gen_lineitem` / `_rand_dates`: copies of the reference's generator
  (tpch.py:91-128), so the same seed gives the same rows in both packages;
* `q1_dag` / `q6_dag`: the DAGRequests the reference planner pushes for
  tpch.Q1 and tpch.Q6 (selection + aggregation over one lineitem scan),
  the same expression trees, types and constants;
* `topn_dag` / `multikey_topn_dag`: the TopN DAGs pushed for TOPN
  (tpch.TOPN) and MULTIKEY_TOPN (bench.py's multikey_topn ORDER BY, with
  l_linenumber selected: the reference planner pushes a TopN only when
  every sort key is a column of the projection below the Sort);
* `q18_inner_dag`: the aggregation pushed for Q18_INNER, the subquery of
  TPC-H Q18 (spec 2.4.18; its HAVING runs above the cop);
* `fn_mix_dag` / `fn_math_dag`: the aggregations pushed for FN_MIX and
  FN_MATH, lineitem aggregated through the builtins past arithmetic
  (division with NULL on a zero divisor, CASE / IF / COALESCE / NULLIF,
  DIV / MOD, the date fields, CEIL / FLOOR / ROUND, the math functions,
  CAST, GREATEST, the bit operators);
* `checksum_dag`: the aggregation pushed for CHECKSUM, a per-group
  BIT_XOR / BIT_OR / BIT_AND checksum of lineitem in the way
  pt-table-checksum folds row checksums with BIT_XOR;
* `window_sum_partition_spec` / `window_rank_frames_spec`: for
  WINDOW_SUM_PARTITION (bench.py's window_sum_partition SQL) and
  WINDOW_RANK_FRAMES (rankings, the previous row, a moving max and a
  value-range sum per supplier), the scan DAG under the window and the
  window spec (part_by, order_by, funcs, out_fts) the reference planner
  builds for the same SQL (its Window plan over a full lineitem scan);
* `ORDERS` / `CUSTOMER` and `gen_orders` / `gen_customer` /
  `generated_columns`: the other two tables of the reference's TPC-H
  setup (tpch.py:45-66 DDL, :129-163 generators), the same rows per seed;
* `q3_mpp_plan` / `q10_mpp_plan` / `q18_mpp_plan`: for Q3, Q10 and Q18 the
  MPPPlan the reference's `slice_plan` cuts from its optimized plan (the
  plan before the engine restreams it), with the steps above the gather
  as its `root_step` (executor/mpp_gather.RootStep);
* `scalar_revenue_mpp_plan`: the same for SCALAR_REVENUE, a join aggregate
  without GROUP BY (Q14's and Q19's shape: the dense mode with no key).
* `PT`, `point_agg_table` / `point_agg_dag`: the launch batcher's workload
  (tools/bench_sched.py): `pt(id INT PRIMARY KEY, v INT, w INT)` cut into
  one region batch per task's id range, and the DAG the reference pushes
  for POINT_AGG over one range (the range is the region's span, so the
  DAG has no selection); `point_topn_dag` / `point_topn_multi_dag`: the
  TopN DAGs pushed for POINT_TOPN / POINT_TOPN_MULTI over the same rows;
* `region_batches`: a batch cut at the reference's region split points
  (storage/txn.py:440 region_split_size, :1600-1608 _auto_split_run);
* `LINEITEM_DDL` and `bulk_load` (tpch.py:28 and :214, with its legacy
  route, tidb_bulk_ingest=OFF, :259): columns into the port's store
  (storage/txn.py) through the bulk engine (br/ingest.BulkIngest), which
  splits the regions as the reference's store does; the tables carry the
  indexes the reference's DDL creates (lineitem's idx_ship; a PRIMARY
  index on each clustered key).
"""

from __future__ import annotations

import numpy as np

from ..br.ingest import datum_for
from ..catalog.schema import ColumnInfo, IndexInfo, TableInfo
from ..codec import tablecodec
from ..codec.row import encode_row
from ..copr.tilecache import ColumnBatch
from ..copr.dag import AggNode, DAGRequest, ScanNode, SelectionNode, TopNNode
from ..executor.mpp_gather import RootStep
from ..expr.aggregation import AggDesc, Frame, WinDesc, agg_ret_type
from ..expr import builtins  # noqa: F401 — the registry
from ..expr.expression import FUNCS, Column, Constant, ScalarFunc, make_func
from ..mysqltypes.coretime import parse_datetime
from ..mysqltypes.datum import K_DEC, K_DUR, K_FLOAT, K_INT, K_STR, K_TIME, K_UINT, Datum
from ..mysqltypes.field_type import NOT_NULL_FLAG, FieldType, TypeCode, ft_decimal, ft_double, ft_longlong, ft_varchar
from ..planner.fragment import JoinFrag, MPPPlan, ScanFrag
from ..planner.plans import Aggregation, DataSource, PlanCol
from ..mysqltypes.mydecimal import dec_from_string

Q1 = """SELECT l_returnflag, l_linestatus,
  SUM(l_quantity) AS sum_qty,
  SUM(l_extendedprice) AS sum_base_price,
  SUM(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
  SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
  AVG(l_quantity) AS avg_qty,
  AVG(l_extendedprice) AS avg_price,
  AVG(l_discount) AS avg_disc,
  COUNT(*) AS count_order
FROM lineitem
WHERE l_shipdate <= '1998-09-02'
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus"""

Q6 = """SELECT SUM(l_extendedprice * l_discount) AS revenue
FROM lineitem
WHERE l_shipdate >= '1994-01-01' AND l_shipdate < '1995-01-01'
  AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24"""


TOPN = "SELECT l_orderkey, l_extendedprice FROM lineitem ORDER BY l_extendedprice DESC LIMIT 100"

MULTIKEY_TOPN = """SELECT l_orderkey, l_extendedprice, l_linenumber FROM lineitem
ORDER BY l_extendedprice DESC, l_orderkey, l_linenumber LIMIT 50"""

Q18_INNER = "SELECT l_orderkey, SUM(l_quantity) FROM lineitem GROUP BY l_orderkey"

Q3 = """SELECT o.o_orderkey, SUM(l.l_extendedprice * (1 - l.l_discount)) AS revenue, o.o_orderdate
FROM customer c JOIN orders o ON c.c_custkey = o.o_custkey
JOIN lineitem l ON l.l_orderkey = o.o_orderkey
WHERE c.c_mktsegment = 'BUILDING' AND o.o_orderdate < '1995-03-15' AND l.l_shipdate > '1995-03-15'
GROUP BY o.o_orderkey, o.o_orderdate
ORDER BY revenue DESC LIMIT 10"""

Q10 = """SELECT c.c_custkey, c.c_name, SUM(l.l_extendedprice * (1 - l.l_discount)) AS revenue
FROM customer c JOIN orders o ON c.c_custkey = o.o_custkey
JOIN lineitem l ON l.l_orderkey = o.o_orderkey
WHERE l.l_returnflag = 'R'
GROUP BY c.c_custkey, c.c_name ORDER BY revenue DESC, c.c_custkey LIMIT 20"""

# Q3 with a TopN too wide for the clustered mode's block top-k (the
# reference demotes it to the rowpos mode: topn_too_wide)
Q3_TOP100 = Q3.replace("LIMIT 10", "LIMIT 100")

# TPC-H Q5's shape — revenue by one dimension attribute of the customer —
# over the generator's three tables (c_mktsegment stands in for n_name):
# a dense join aggregate with count, sum, avg, min and max
SEG_REVENUE = """SELECT c.c_mktsegment, COUNT(*),
       SUM(l.l_extendedprice * (1 - l.l_discount)) AS revenue,
       AVG(l.l_quantity), MIN(l.l_discount), MAX(l.l_extendedprice)
FROM customer c JOIN orders o ON c.c_custkey = o.o_custkey
JOIN lineitem l ON l.l_orderkey = o.o_orderkey
WHERE l.l_shipdate > '1995-03-15'
GROUP BY c.c_mktsegment"""

# a per-group checksum of lineitem, folded with the bitwise aggregates as
# pt-table-checksum folds its row checksums with BIT_XOR
CHECKSUM = """SELECT l_returnflag, COUNT(*), BIT_XOR(l_orderkey), BIT_OR(l_partkey),
       BIT_AND(l_extendedprice * (1 - l_discount))
FROM lineitem WHERE l_shipdate <= '1998-09-02' GROUP BY l_returnflag"""

# the builtins beyond arithmetic on the cop path: division by a lane with
# zero divisors (NULL where l_quantity = 25), CASE / IF / COALESCE /
# NULLIF, DIV and MOD, the date fields, CEIL and ROUND (a float ROUND of a
# decimal product); the reference runs both on its device with no fallback
FN_MIX = """SELECT l_returnflag, l_linestatus, COUNT(*),
  SUM(CASE WHEN l_discount >= 0.05 THEN l_extendedprice * (1 - l_discount) ELSE l_extendedprice END),
  SUM(l_extendedprice / (l_quantity - 25)), COUNT(l_extendedprice / (l_quantity - 25)),
  SUM(IF(l_receiptdate > l_commitdate, l_extendedprice DIV 100, 0)),
  MIN(COALESCE(NULLIF(l_linenumber MOD 3, 0), -1)), MAX(DAYOFMONTH(l_receiptdate)),
  SUM(CEIL(l_extendedprice / 7)), SUM(ROUND(l_extendedprice * 1.0e0 * (1 - l_discount), 2))
FROM lineitem
WHERE MONTH(l_shipdate) IN (1, 4, 7, 10) AND YEAR(l_shipdate) BETWEEN 1993 AND 1997 AND l_quantity MOD 7 <> 0
GROUP BY l_returnflag, l_linestatus"""

# the math functions, ABS / SIGN / FLOOR, CAST AS SIGNED, GREATEST and the
# bit operators
FN_MATH = """SELECT l_returnflag, l_linestatus,
  SUM(SQRT(l_quantity)), SUM(LN(l_extendedprice)), MAX(POW(l_discount, 2)),
  SUM(ABS(l_tax - 0.04)), MIN(SIGN(l_tax - 0.04)), SUM(FLOOR(l_extendedprice / 1000)),
  SUM(CAST(l_extendedprice AS SIGNED)), MAX(GREATEST(l_quantity, l_tax * 100)), BIT_OR(l_partkey >> 3),
  SUM(EXP(-l_discount) * COS(l_tax))
FROM lineitem WHERE DAYOFMONTH(l_shipdate) <= 15 AND (l_linenumber & 1) = 1
GROUP BY l_returnflag, l_linestatus"""

# a join aggregate with no GROUP BY (TPC-H Q14's and Q19's shape)
SCALAR_REVENUE = ("SELECT SUM(l_extendedprice * (1 - l_discount)) FROM lineitem JOIN orders "
                  "ON l_orderkey = o_orderkey WHERE o_orderdate < '1995-03-15'")

Q18 = """SELECT o.o_orderkey, SUM(l.l_quantity) AS total_qty
FROM orders o JOIN lineitem l ON l.l_orderkey = o.o_orderkey
GROUP BY o.o_orderkey HAVING SUM(l.l_quantity) > 100
ORDER BY total_qty DESC, o.o_orderkey LIMIT 10"""

WINDOW_SUM_PARTITION = """SELECT SUM(l_quantity) OVER (PARTITION BY l_returnflag, l_linestatus
  ORDER BY l_shipdate, l_orderkey, l_linenumber) FROM lineitem"""

WINDOW_RANK_FRAMES = """SELECT l_orderkey,
  ROW_NUMBER() OVER (PARTITION BY l_suppkey ORDER BY l_orderkey),
  RANK() OVER (PARTITION BY l_suppkey ORDER BY l_orderkey),
  LAG(l_extendedprice) OVER (PARTITION BY l_suppkey ORDER BY l_orderkey),
  MAX(l_extendedprice) OVER (PARTITION BY l_suppkey ORDER BY l_orderkey
                             ROWS BETWEEN 3 PRECEDING AND 3 FOLLOWING),
  SUM(l_quantity) OVER (PARTITION BY l_suppkey ORDER BY l_orderkey
                        RANGE BETWEEN 1000 PRECEDING AND CURRENT ROW)
FROM lineitem"""


def _nn(tp: TypeCode, **kw) -> FieldType:
    return FieldType(tp, flag=NOT_NULL_FLAG, **kw)


_COLS = [
    ("l_orderkey", _nn(TypeCode.Longlong)),
    ("l_partkey", _nn(TypeCode.Longlong)),
    ("l_suppkey", _nn(TypeCode.Longlong)),
    ("l_linenumber", _nn(TypeCode.Longlong)),
    ("l_quantity", _nn(TypeCode.NewDecimal, flen=15, decimal=2)),
    ("l_extendedprice", _nn(TypeCode.NewDecimal, flen=15, decimal=2)),
    ("l_discount", _nn(TypeCode.NewDecimal, flen=15, decimal=2)),
    ("l_tax", _nn(TypeCode.NewDecimal, flen=15, decimal=2)),
    ("l_returnflag", _nn(TypeCode.String, flen=1)),
    ("l_linestatus", _nn(TypeCode.String, flen=1)),
    ("l_shipdate", _nn(TypeCode.Date)),
    ("l_commitdate", _nn(TypeCode.Date)),
    ("l_receiptdate", _nn(TypeCode.Date)),
]

LINEITEM_DDL = """CREATE TABLE lineitem (
  l_orderkey BIGINT NOT NULL,
  l_partkey BIGINT NOT NULL,
  l_suppkey BIGINT NOT NULL,
  l_linenumber BIGINT NOT NULL,
  l_quantity DECIMAL(15,2) NOT NULL,
  l_extendedprice DECIMAL(15,2) NOT NULL,
  l_discount DECIMAL(15,2) NOT NULL,
  l_tax DECIMAL(15,2) NOT NULL,
  l_returnflag CHAR(1) NOT NULL,
  l_linestatus CHAR(1) NOT NULL,
  l_shipdate DATE NOT NULL,
  l_commitdate DATE NOT NULL,
  l_receiptdate DATE NOT NULL,
  KEY idx_ship (l_shipdate)
)"""

# what the reference's CREATE TABLE builds from LINEITEM_DDL (session.py
# _build_table_info), ids aside: no primary key, so the hidden
# _tidb_rowid is the handle, and the secondary index idx_ship
LINEITEM = TableInfo(
    1, "lineitem",
    [ColumnInfo(2 + i, name, ft, i) for i, (name, ft) in enumerate(_COLS)]
    + [ColumnInfo(2 + len(_COLS), "_tidb_rowid", ft_longlong(), len(_COLS), hidden=True)],
    [IndexInfo(3 + len(_COLS), "idx_ship", [10])], db_name="test",
)


_ORDERS_COLS = [
    ("o_orderkey", _nn(TypeCode.Longlong)),
    ("o_custkey", _nn(TypeCode.Longlong)),
    ("o_orderstatus", _nn(TypeCode.String, flen=1)),
    ("o_totalprice", _nn(TypeCode.NewDecimal, flen=15, decimal=2)),
    ("o_orderdate", _nn(TypeCode.Date)),
    ("o_orderpriority", _nn(TypeCode.String, flen=15)),
    ("o_shippriority", _nn(TypeCode.Longlong)),
]

_CUSTOMER_COLS = [
    ("c_custkey", _nn(TypeCode.Longlong)),
    ("c_name", _nn(TypeCode.Varchar, flen=25)),
    ("c_mktsegment", _nn(TypeCode.String, flen=10)),
    ("c_acctbal", _nn(TypeCode.NewDecimal, flen=15, decimal=2)),
]

# o_orderkey and c_custkey are clustered BIGINT primary keys: the key is the
# row handle, so neither table has a hidden _tidb_rowid column
ORDERS = TableInfo(2, "orders", [ColumnInfo(20 + i, name, ft, i) for i, (name, ft) in enumerate(_ORDERS_COLS)],
                   [IndexInfo(27, "PRIMARY", [0], unique=True, primary=True)], pk_is_handle=True, db_name="test")
CUSTOMER = TableInfo(3, "customer", [ColumnInfo(30 + i, name, ft, i) for i, (name, ft) in enumerate(_CUSTOMER_COLS)],
                     [IndexInfo(34, "PRIMARY", [0], unique=True, primary=True)], pk_is_handle=True, db_name="test")


def _rand_dates(rng, n, y0=1992, y1=1998):
    """Packed date int64s uniform over [y0, y1]."""
    years = rng.integers(y0, y1 + 1, n)
    months = rng.integers(1, 13, n)
    days = rng.integers(1, 29, n)
    return ((years * 13 + months) * 32 + days) * (24 * 60 * 60 * 1_000_000)


def gen_lineitem(n_rows: int, seed: int = 42) -> dict[str, np.ndarray]:
    """Generate lineitem columns, distribution-shaped like dbgen."""
    rng = np.random.default_rng(seed)
    orderkey = np.sort(rng.integers(1, max(n_rows // 4, 2), n_rows))
    qty = rng.integers(100, 5100, n_rows)  # 1.00..51.00 scale 2
    price = rng.integers(90000, 10500000, n_rows)  # 900.00..105000.00
    discount = rng.integers(0, 11, n_rows)  # 0.00..0.10
    tax = rng.integers(0, 9, n_rows)
    shipdate = _rand_dates(rng, n_rows)
    rf = rng.choice(np.array(["A", "N", "R"], dtype=object), n_rows, p=[0.25, 0.5, 0.25])
    ls = np.where(rng.random(n_rows) < 0.5, "O", "F").astype(object)
    return {
        "l_orderkey": orderkey,
        "l_partkey": rng.integers(1, 200000, n_rows),
        "l_suppkey": rng.integers(1, 10000, n_rows),
        "l_linenumber": rng.integers(1, 8, n_rows),
        "l_quantity": qty,
        "l_extendedprice": price,
        "l_discount": discount,
        "l_tax": tax,
        "l_returnflag": rf,
        "l_linestatus": ls,
        "l_shipdate": shipdate,
        "l_commitdate": shipdate + 32 * 24 * 3600 * 1_000_000,
        "l_receiptdate": shipdate + 33 * 24 * 3600 * 1_000_000,
    }


def gen_orders(n_orders: int, n_cust: int, seed: int = 43) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    prios = np.array(["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"], dtype=object)
    return {
        "o_orderkey": np.arange(1, n_orders + 1, dtype=np.int64),
        "o_custkey": rng.integers(1, n_cust + 1, n_orders),
        "o_orderstatus": np.where(rng.random(n_orders) < 0.5, "O", "F").astype(object),
        "o_totalprice": rng.integers(90000, 50000000, n_orders),
        "o_orderdate": _rand_dates(rng, n_orders),
        "o_orderpriority": rng.choice(prios, n_orders),
        "o_shippriority": np.zeros(n_orders, dtype=np.int64),
    }


def gen_customer(n_cust: int, seed: int = 44) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    segs = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"], dtype=object)
    return {
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_name": np.array([f"Customer#{i:09d}" for i in range(1, n_cust + 1)], dtype=object),
        "c_mktsegment": rng.choice(segs, n_cust),
        "c_acctbal": rng.integers(-99999, 999999, n_cust),
    }


def generated_columns(n_lineitem: int, seed: int = 42):
    """The (lineitem, orders, customer) column dicts the reference's
    setup_tpch loads: orders = rows/4, customers = orders/10."""
    n_orders = max(n_lineitem // 4, 2)
    n_cust = max(n_orders // 10, 2)
    return (
        gen_lineitem(n_lineitem, seed),
        gen_orders(n_orders, n_cust, seed + 1),
        gen_customer(n_cust, seed + 2),
    )


def _col(name: str) -> Column:
    c = LINEITEM.col_by_name(name)
    return Column(c.offset, c.ft, c.name)


def _date(s: str) -> Constant:
    """A date literal as the planner folds it against a DATE column: the
    string parses to a packed datetime constant of the column's type."""
    return Constant(Datum.t(parse_datetime(s)), LINEITEM.col_by_name("l_shipdate").ft.clone())


def _int(v: int) -> Constant:
    return Constant(Datum.i(v), ft_longlong())


def _dec(s: str, scale: int) -> Constant:
    return Constant(Datum.d(dec_from_string(s)), ft_decimal(30, scale))


def _scan() -> ScanNode:
    vis = LINEITEM.visible_columns()
    return ScanNode(LINEITEM.id, [c.offset for c in vis], [c.ft for c in vis], [c.id for c in vis])


def q1_dag() -> DAGRequest:
    price, disc, tax = _col("l_extendedprice"), _col("l_discount"), _col("l_tax")
    disc_price = make_func("mul", price, make_func("minus", _int(1), disc))
    charge = make_func("mul", make_func("mul", price, make_func("minus", _int(1), disc)),
                       make_func("plus", _int(1), tax))
    aggs = [
        AggDesc.make("sum", [_col("l_quantity")]),
        AggDesc.make("sum", [price]),
        AggDesc.make("sum", [disc_price]),
        AggDesc.make("sum", [charge]),
        AggDesc.make("avg", [_col("l_quantity")]),
        AggDesc.make("avg", [price]),
        AggDesc.make("avg", [disc]),
        AggDesc.make("count", []),
    ]
    return DAGRequest(
        scan=_scan(),
        selection=SelectionNode([make_func("le", _col("l_shipdate"), _date("1998-09-02"))]),
        agg=AggNode([_col("l_returnflag"), _col("l_linestatus")], aggs),
    )


def q6_dag() -> DAGRequest:
    ship, disc, qty = _col("l_shipdate"), _col("l_discount"), _col("l_quantity")
    conds = [
        make_func("ge", ship, _date("1994-01-01")),
        make_func("lt", ship, _date("1995-01-01")),
        make_func("ge", disc, _dec("0.05", 2)),
        make_func("le", disc, _dec("0.07", 2)),
        make_func("lt", qty, _int(24)),
    ]
    revenue = AggDesc.make("sum", [make_func("mul", _col("l_extendedprice"), disc)])
    return DAGRequest(scan=_scan(), selection=SelectionNode(conds), agg=AggNode([], [revenue]))


def _float(v: float) -> Constant:
    return Constant(Datum.f(v), ft_double())


def fn_mix_dag() -> DAGRequest:
    """The aggregation the reference planner pushes for FN_MIX."""
    price, disc, qty = _col("l_extendedprice"), _col("l_discount"), _col("l_quantity")
    ship, recv = _col("l_shipdate"), _col("l_receiptdate")
    per_qty = make_func("div", price, make_func("minus", qty, _int(25)))
    aggs = [
        AggDesc.make("count", []),
        AggDesc.make("sum", [make_func("case", make_func("ge", disc, _dec("0.05", 2)),
                                       make_func("mul", price, make_func("minus", _int(1), disc)), price)]),
        AggDesc.make("sum", [per_qty]),
        AggDesc.make("count", [per_qty]),
        AggDesc.make("sum", [make_func("if", make_func("gt", recv, _col("l_commitdate")),
                                       make_func("intdiv", price, _int(100)), _int(0))]),
        AggDesc.make("min", [make_func("coalesce", make_func("nullif", make_func("mod", _col("l_linenumber"), _int(3)),
                                                             _int(0)), make_func("unaryminus", _int(1)))]),
        AggDesc.make("max", [make_func("dayofmonth", recv)]),
        AggDesc.make("sum", [make_func("ceil", make_func("div", price, _int(7)))]),
        AggDesc.make("sum", [make_func("round", make_func("mul", make_func("mul", price, _float(1.0)),
                                                          make_func("minus", _int(1), disc)), _int(2))]),
    ]
    conds = [
        make_func("in", make_func("month", ship), _int(1), _int(4), _int(7), _int(10)),
        make_func("ge", make_func("year", ship), _int(1993)),
        make_func("le", make_func("year", ship), _int(1997)),
        make_func("ne", make_func("mod", qty, _int(7)), _int(0)),
    ]
    return DAGRequest(scan=_scan(), selection=SelectionNode(conds),
                      agg=AggNode([_col("l_returnflag"), _col("l_linestatus")], aggs))


def fn_math_dag() -> DAGRequest:
    """The aggregation the reference planner pushes for FN_MATH."""
    price, disc, qty, tax = _col("l_extendedprice"), _col("l_discount"), _col("l_quantity"), _col("l_tax")
    tax_off = make_func("minus", tax, _dec("0.04", 2))
    aggs = [
        AggDesc.make("sum", [make_func("sqrt", qty)]),
        AggDesc.make("sum", [make_func("ln", price)]),
        AggDesc.make("max", [make_func("pow", disc, _int(2))]),
        AggDesc.make("sum", [make_func("abs", tax_off)]),
        AggDesc.make("min", [make_func("sign", tax_off)]),
        AggDesc.make("sum", [make_func("floor", make_func("div", price, _int(1000)))]),
        AggDesc.make("sum", [ScalarFunc(FUNCS["cast"], [price], FieldType(TypeCode.Longlong))]),
        AggDesc.make("max", [make_func("greatest", qty, make_func("mul", tax, _int(100)))]),
        AggDesc.make("bit_or", [make_func("rshift", _col("l_partkey"), _int(3))]),
        AggDesc.make("sum", [make_func("mul", make_func("exp", make_func("unaryminus", disc)), make_func("cos", tax))]),
    ]
    conds = [
        make_func("le", make_func("dayofmonth", _col("l_shipdate")), _int(15)),
        make_func("eq", make_func("bitand", _col("l_linenumber"), _int(1)), _int(1)),
    ]
    return DAGRequest(scan=_scan(), selection=SelectionNode(conds),
                      agg=AggNode([_col("l_returnflag"), _col("l_linestatus")], aggs))


def checksum_dag() -> DAGRequest:
    price, disc = _col("l_extendedprice"), _col("l_discount")
    aggs = [
        AggDesc.make("count", []),
        AggDesc.make("bit_xor", [_col("l_orderkey")]),
        AggDesc.make("bit_or", [_col("l_partkey")]),
        AggDesc.make("bit_and", [make_func("mul", price, make_func("minus", _int(1), disc))]),
    ]
    return DAGRequest(scan=_scan(),
                      selection=SelectionNode([make_func("le", _col("l_shipdate"), _date("1998-09-02"))]),
                      agg=AggNode([_col("l_returnflag")], aggs))


def topn_dag() -> DAGRequest:
    return DAGRequest(scan=_scan(), topn=TopNNode([(_col("l_extendedprice"), True)], 100))


def multikey_topn_dag() -> DAGRequest:
    by = [(_col("l_extendedprice"), True), (_col("l_orderkey"), False), (_col("l_linenumber"), False)]
    return DAGRequest(scan=_scan(), topn=TopNNode(by, 50))


def q18_inner_dag() -> DAGRequest:
    return DAGRequest(scan=_scan(), agg=AggNode([_col("l_orderkey")],
                                                [AggDesc.make("sum", [_col("l_quantity")])]))


def _window(part, order, funcs):
    out_fts = [c.ft for c in LINEITEM.visible_columns()] + [f.ret_type for f in funcs]
    return DAGRequest(scan=_scan()), (part, order, funcs, out_fts)


def window_sum_partition_spec():
    """(scan DAG, (part_by, order_by, funcs, out_fts)) of WINDOW_SUM_PARTITION."""
    part = [_col("l_returnflag"), _col("l_linestatus")]
    order = [(_col("l_shipdate"), False), (_col("l_orderkey"), False), (_col("l_linenumber"), False)]
    qty = _col("l_quantity")
    return _window(part, order, [WinDesc("sum", [qty], part, order, agg_ret_type("sum", qty.ret_type))])


def window_rank_frames_spec():
    """(scan DAG, (part_by, order_by, funcs, out_fts)) of WINDOW_RANK_FRAMES."""
    part = [_col("l_suppkey")]
    order = [(_col("l_orderkey"), False)]
    price, qty = _col("l_extendedprice"), _col("l_quantity")
    funcs = [
        WinDesc("row_number", [], part, order, ft_longlong()),
        WinDesc("rank", [], part, order, ft_longlong()),
        WinDesc("lag", [price], part, order, price.ret_type.clone()),
        WinDesc("max", [price], part, order, price.ret_type.clone(), Frame("rows", "pre", 3, "fol", 3)),
        WinDesc("sum", [qty], part, order, agg_ret_type("sum", qty.ret_type),
                Frame("range", "pre", 1000, "cur", 0)),
    ]
    return _window(part, order, funcs)


# --- MPP plans ---------------------------------------------------------------
#
# The joined schema of a fragment plan is the scans' columns side by side,
# in the order slice_plan meets them (customer, orders, lineitem for Q3 and
# Q10; orders, lineitem for Q18). Every scan reads all visible columns.

TABLES = {"lineitem": LINEITEM, "orders": ORDERS, "customer": CUSTOMER}


def _scan_frag(table: TableInfo, alias: str, side_offset: int) -> ScanFrag:
    cols = [PlanCol(c.name, c.ft, alias, c.offset) for c in table.visible_columns()]
    return ScanFrag(DataSource(table, alias, cols), side_offset)


def _jcol(frag: ScanFrag, name: str) -> Column:
    """A column of `frag` in the joined schema."""
    c = frag.ds.table.col_by_name(name)
    return Column(frag.side_offset + c.offset, c.ft, c.name)


def _lcol(frag: ScanFrag, name: str) -> Column:
    """A column of `frag` in its scan-local schema (pushed conditions)."""
    c = frag.ds.table.col_by_name(name)
    return Column(c.offset, c.ft, c.name)


def _date_of(ft: FieldType, s: str) -> Constant:
    return Constant(Datum.t(parse_datetime(s)), ft.clone())


def _str(s: str) -> Constant:
    ft = ft_varchar(len(s))
    ft.flag = 0
    return Constant(Datum.s(s), ft)


def _cust_orders_lineitem():
    c = _scan_frag(CUSTOMER, "c", 0)
    o = _scan_frag(ORDERS, "o", c.side_offset + c.n_cols)
    li = _scan_frag(LINEITEM, "l", o.side_offset + o.n_cols)
    co = JoinFrag(c, o, "inner", [_jcol(c, "c_custkey").idx], [_jcol(o, "o_custkey").idx])
    root = JoinFrag(co, li, "inner", [_jcol(o, "o_orderkey").idx], [_jcol(li, "l_orderkey").idx])
    return c, o, li, root


def _revenue(li: ScanFrag) -> AggDesc:
    price, disc = _jcol(li, "l_extendedprice"), _jcol(li, "l_discount")
    return AggDesc.make("sum", [make_func("mul", price, make_func("minus", _int(1), disc))])


def _agg(group_by: list[Column], aggs: list[AggDesc]) -> Aggregation:
    cols = [PlanCol(f"g{i}", g.ret_type) for i, g in enumerate(group_by)]
    cols += [PlanCol(f"a{i}", a.ret_type) for i, a in enumerate(aggs)]
    return Aggregation(None, group_by, aggs, cols)  # no child: the plan is built by hand


def _out_cols(*frags: ScanFrag) -> list[PlanCol]:
    return [pc for f in frags for pc in f.ds.out_cols]


def q3_mpp_plan(limit: int = 10) -> MPPPlan:
    """Q3: a fused ORDER BY revenue DESC LIMIT `limit` over the partial
    agg (Q3_TOP100 with limit=100); above the gather the final agg, then
    the projection (o_orderkey, revenue, o_orderdate) and the TopN."""
    c, o, li, root = _cust_orders_lineitem()
    c.ds.pushed_conds = [make_func("eq", _lcol(c, "c_mktsegment"), _str("BUILDING"))]
    o.ds.pushed_conds = [make_func("lt", _lcol(o, "o_orderdate"),
                                   _date_of(ORDERS.col_by_name("o_orderdate").ft, "1995-03-15"))]
    li.ds.pushed_conds = [make_func("gt", _lcol(li, "l_shipdate"),
                                    _date_of(LINEITEM.col_by_name("l_shipdate").ft, "1995-03-15"))]
    agg = _agg([_jcol(o, "o_orderkey"), _jcol(o, "o_orderdate")], [_revenue(li)])
    revenue = Column(1, agg.aggs[0].ret_type, "revenue")
    return MPPPlan(root, [c, o, li], agg, _out_cols(c, o, li), topn=(0, True, limit),
                   root_step=RootStep(proj=[0, 2, 1], by=[(revenue, True)], n=limit))


def q10_mpp_plan() -> MPPPlan:
    """Q10: no fused TopN (two sort keys); above the gather the final
    agg, then the TopN revenue DESC, c_custkey LIMIT 20."""
    c, o, li, root = _cust_orders_lineitem()
    li.ds.pushed_conds = [make_func("eq", _lcol(li, "l_returnflag"), _str("R"))]
    agg = _agg([_jcol(c, "c_custkey"), _jcol(c, "c_name")], [_revenue(li)])
    revenue = Column(2, agg.aggs[0].ret_type, "revenue")
    custkey = Column(0, CUSTOMER.col_by_name("c_custkey").ft, "c_custkey")
    return MPPPlan(root, [c, o, li], agg, _out_cols(c, o, li),
                   root_step=RootStep(proj=[0, 1, 2], by=[(revenue, True), (custkey, False)], n=20))


def q18_mpp_plan() -> MPPPlan:
    """Q18: one level whose build side (lineitem) has duplicate keys, no
    fused TopN (two sort keys); above the gather the final agg, the HAVING
    SUM(l_quantity) > 100, then the TopN total_qty DESC, o_orderkey LIMIT
    10."""
    o = _scan_frag(ORDERS, "o", 0)
    li = _scan_frag(LINEITEM, "l", o.n_cols)
    root = JoinFrag(o, li, "inner", [_jcol(o, "o_orderkey").idx], [_jcol(li, "l_orderkey").idx])
    agg = _agg([_jcol(o, "o_orderkey")], [AggDesc.make("sum", [_jcol(li, "l_quantity")])])
    qty_ft, key_ft = agg.aggs[0].ret_type, ORDERS.col_by_name("o_orderkey").ft
    step = RootStep(proj=[0, 1], by=[(Column(1, qty_ft, "total_qty"), True), (Column(0, key_ft, "o_orderkey"), False)],
                    n=10, having=[make_func("gt", Column(1, qty_ft, "a0"), _int(100))])
    return MPPPlan(root, [o, li], agg, _out_cols(o, li), root_step=step)


def seg_revenue_mpp_plan() -> MPPPlan:
    """SEG_REVENUE: Q3's chain with the lineitem date filter, the dense
    aggregation by c_mktsegment (5 values) with count, sum, avg, min and
    max; above the gather the final agg and its projection."""
    c, o, li, root = _cust_orders_lineitem()
    li.ds.pushed_conds = [make_func("gt", _lcol(li, "l_shipdate"),
                                    _date_of(LINEITEM.col_by_name("l_shipdate").ft, "1995-03-15"))]
    aggs = [AggDesc.make("count", []), _revenue(li), AggDesc.make("avg", [_jcol(li, "l_quantity")]),
            AggDesc.make("min", [_jcol(li, "l_discount")]), AggDesc.make("max", [_jcol(li, "l_extendedprice")])]
    agg = _agg([_jcol(c, "c_mktsegment")], aggs)
    return MPPPlan(root, [c, o, li], agg, _out_cols(c, o, li), root_step=RootStep(proj=list(range(6))))


def scalar_revenue_mpp_plan() -> MPPPlan:
    """SCALAR_REVENUE: lineitem probes the date-filtered orders, one
    aggregate and no group key; above the gather the final agg and its
    projection."""
    li = _scan_frag(LINEITEM, "lineitem", 0)
    o = _scan_frag(ORDERS, "orders", li.n_cols)
    o.ds.pushed_conds = [make_func("lt", _lcol(o, "o_orderdate"),
                                   _date_of(ORDERS.col_by_name("o_orderdate").ft, "1995-03-15"))]
    root = JoinFrag(li, o, "inner", [_jcol(li, "l_orderkey").idx], [_jcol(o, "o_orderkey").idx])
    return MPPPlan(root, [li, o], _agg([], [_revenue(li)]), _out_cols(li, o), root_step=RootStep(proj=[0]))


# --- the launch batcher's workload (tools/bench_sched.py) -------------------

POINT_AGG = "SELECT COUNT(*), SUM(v), MIN(v), MAX(w) FROM pt WHERE id >= {lo} AND id < {hi}"

# pt(id INT PRIMARY KEY, v INT, w INT): the clustered INT key is the row
# handle, so the table has no hidden _tidb_rowid column
PT = TableInfo(4, "pt", [ColumnInfo(40, "id", FieldType(TypeCode.Long, flag=NOT_NULL_FLAG), 0),
                         ColumnInfo(41, "v", FieldType(TypeCode.Long), 1),
                         ColumnInfo(42, "w", FieldType(TypeCode.Long), 2)],
               [IndexInfo(43, "PRIMARY", [0], unique=True, primary=True)], pk_is_handle=True, db_name="test")


def point_agg_table(n_tasks: int, rows_per_task: int, seed: int = 0) -> list[ColumnBatch]:
    """The rows tools/bench_sched.py inserts (:99-106: v = id % 997,
    w = (id * 7) % 131, ids 0 .. n_tasks * rows_per_task - 1), as one
    ColumnBatch per task's id range [i * rows, (i + 1) * rows) — the
    region each point aggregation reads. The rows are fixed by the
    workload; `seed` only orders nothing and is kept for the entry points'
    uniform signature."""
    del seed
    out = []
    for i in range(n_tasks):
        ids = np.arange(i * rows_per_task, (i + 1) * rows_per_task, dtype=np.int64)
        ones = np.ones(len(ids), dtype=bool)
        out.append(ColumnBatch(PT, ids.copy(), [ids, ids % 997, (ids * 7) % 131], [ones, ones, ones], version=0,
                               start=int(ids[0]).to_bytes(8, "big"), end=int(ids[-1] + 1).to_bytes(8, "big")))
    return out


def point_agg_dag() -> DAGRequest:
    """The cop DAG of POINT_AGG over one id range: COUNT(*), SUM(v),
    MIN(v), MAX(w) over a scan of all three columns."""
    cols = [Column(c.offset, c.ft, c.name) for c in PT.columns]
    aggs = [AggDesc.make("count", []), AggDesc.make("sum", [cols[1]]), AggDesc.make("min", [cols[1]]),
            AggDesc.make("max", [cols[2]])]
    scan = ScanNode(PT.id, [c.offset for c in PT.columns], [c.ft for c in PT.columns], [c.id for c in PT.columns])
    return DAGRequest(scan=scan, agg=AggNode([], aggs))


POINT_TOPN = "SELECT id, v, w FROM pt WHERE id >= {lo} AND id < {hi} ORDER BY v DESC LIMIT 10"
POINT_TOPN_MULTI = "SELECT id, v, w FROM pt WHERE id >= {lo} AND id < {hi} ORDER BY w, v DESC LIMIT 10"


def _pt_topn(by) -> DAGRequest:
    cols = [Column(c.offset, c.ft, c.name) for c in PT.columns]
    scan = ScanNode(PT.id, [c.offset for c in PT.columns], [c.ft for c in PT.columns], [c.id for c in PT.columns])
    return DAGRequest(scan=scan, topn=TopNNode([(cols[i], desc) for i, desc in by], 10))


def point_topn_dag() -> DAGRequest:
    """The cop DAG of POINT_TOPN over one id range: ORDER BY v DESC LIMIT
    10 over a scan of all three columns (no selection, as POINT_AGG's)."""
    return _pt_topn([(1, True)])


def point_topn_multi_dag() -> DAGRequest:
    """The cop DAG of POINT_TOPN_MULTI: ORDER BY w, v DESC LIMIT 10."""
    return _pt_topn([(2, False), (1, True)])


def region_batches(batch: ColumnBatch, split: int = 1 << 21) -> list[ColumnBatch]:
    """`batch` cut into the regions the reference's store splits a bulk
    ingest into: a cut at every `split`-th row short of the last half
    region, none below 2 * split rows (_auto_split_run). 16,000,000 rows
    give 7 regions of 2,097,152 and one of 1,319,936."""
    n = batch.n_rows
    cuts = list(range(split, n - split // 2, split)) if n >= 2 * split else []
    bounds = [0] + cuts + [n]
    return [ColumnBatch(batch.table, batch.handles[a:b], [d[a:b] for d in batch.data],
                        [v[a:b] for v in batch.valid], batch.version, start=int(a).to_bytes(8, "big"),
                        end=int(b).to_bytes(8, "big"))
            for a, b in zip(bounds, bounds[1:])]


def _kind_of(ft) -> int:
    # ONE definition with the bulk engine (br/ingest.kind_of): a K_INT
    # fallthrough that truncated DOUBLE columns to ints once lived in a
    # private copy of this mapping
    from ..br.ingest import kind_of

    return kind_of(ft)


# kinds the columnar bulk path encodes; K_BYTES stays excluded (the
# trailing-NUL width heuristic would clip binary values ending in 0x00)
_BULK_KINDS = (K_INT, K_UINT, K_FLOAT, K_DEC, K_TIME, K_DUR, K_STR)


def bulk_load(session, table_name: str, columns: dict[str, np.ndarray], kinds: dict[str, int] | None = None, batch: int = 500_000):
    """Bulk-load columns into a table through the ingest path (2PC bypass,
    the Lightning local backend analog; copy of tidb_tpu/models/tpch.py:214).
    `session` is anything with the Session's `.store`, `.current_db`,
    `.vars`, `.cop.tiles`, `.infoschema()` and `.alloc_auto_id()` (the
    Session is a later slice of the port). Rows get sequential handles.
    Column kinds derive from the table schema unless overridden.

    Default route (tidb_bulk_ingest=ON): the shared bulk engine
    (br/ingest.BulkIngest) keeps the data COLUMNAR end to end — canonical
    numpy lanes become a ColumnarRun + IntIndexRun artifacts published
    atomically under one WAL ingest record; no row-major byte plane is
    materialized at load time. OFF (or ineligible kinds) recovers the
    legacy per-batch path: v2 row encode + per-batch segment ingest."""
    info = session.infoschema().table(session.current_db, table_name)
    names = list(columns)
    col_infos = [info.col_by_name(n) for n in names]
    if kinds is None:
        kinds = {n: _kind_of(c.ft) for n, c in zip(names, col_infos)}
    n = len(columns[names[0]])
    kind_list = [kinds[n_] for n_ in names]
    if (
        session.vars.get("tidb_bulk_ingest", "ON") == "ON"
        and info.partition is None
        and all(k in _BULK_KINDS for k in kind_list)
    ):
        from ..br.ingest import BulkIngest, IngestAborted

        try:
            job = BulkIngest(session, info)
        except IngestAborted:
            # DDL queued/running on the table: the legacy per-batch
            # segment path coexists with online DDL as it always did
            job = None
        if job is not None:
            try:
                job.add_columns(names, [columns[nm] for nm in names], kind_list)
                job.commit()
            except IngestAborted:
                job.abort()  # publish-time abort: recover via legacy below
            except BaseException:
                job.abort()
                raise
            else:
                return n
    return _bulk_load_segments(session, info, names, columns, kinds, col_infos, batch)


def _bulk_load_segments(session, info, names, columns, kinds, col_infos, batch):
    """Legacy bulk path (tidb_bulk_ingest=OFF): v2 row-major encode +
    one segment ingest per batch — kept bit-compatible as the live
    fallback and the paired-bench baseline."""
    from ..codec import rowfast

    col_ids = [c.id for c in col_infos]
    n = len(columns[names[0]])
    # clustered int pk: the pk VALUE is the row handle (ref: tables.go
    # AddRecord pkIsHandle) — sequential handles would mis-key PointGet
    # and index back-reads
    pk_handle_pos = None
    if info.pk_is_handle:
        hc = info.handle_col()
        pk_handle_pos = next(i for i, c in enumerate(col_infos) if c.offset == hc.offset)
        first_handle = None
    else:
        first_handle = session.alloc_auto_id(info, n)
    arrays = [columns[n_] for n_ in names]
    kind_list = [kinds[n_] for n_ in names]
    commit_ts = session.store.tso.next()
    scale_fix = [max(c.ft.decimal, 0) if k == K_DEC else 0 for c, k in zip(col_infos, kind_list)]
    indexes = [ix for ix in info.indexes if ix.state not in ("none", "delete_only") and not (info.pk_is_handle and ix.primary)]

    if rowfast.encodable_kinds(kind_list):
        name_pos = {c.offset: i for i, c in enumerate(col_infos)}
        int_kinds = (K_INT, K_TIME)
        mvcc = session.store.mvcc
        for lo in range(0, n, batch):
            hi = min(lo + batch, n)
            m = hi - lo
            arrs = [a[lo:hi] for a in arrays]
            if pk_handle_pos is not None:
                handles = np.asarray(arrs[pk_handle_pos]).astype(np.int64)
                presorted = bool(np.all(np.diff(handles) > 0)) if m > 1 else True
            else:
                handles = np.arange(first_handle + lo, first_handle + hi, dtype=np.int64)
                presorted = True
            buf, offs = rowfast.encode_rows_v2(col_ids, kind_list, scale_fix, arrs)
            key_mat = rowfast.record_key_matrix(info.id, handles)
            mvcc.ingest_run(key_mat, buf, offs[:-1], np.diff(offs), commit_ts, presorted=presorted)
            for ix in indexes:
                poss = [name_pos.get(off) for off in ix.col_offsets]
                if all(p is not None and kind_list[p] in int_kinds for p in poss):
                    kcols = [np.asarray(arrs[p]).astype(np.int64) for p in poss]
                    if ix.unique:
                        imat = rowfast.int_index_key_matrix(info.id, ix.id, kcols, None)
                        vbuf, vstarts, vlens = rowfast.handle_value_buffer(handles)
                        mvcc.ingest_run(imat, vbuf, vstarts, vlens, commit_ts)
                    else:
                        imat = rowfast.int_index_key_matrix(info.id, ix.id, kcols, handles)
                        z = np.zeros(m, dtype=np.int64)
                        mvcc.ingest_run(imat, b"", z, z, commit_ts)
                else:  # string/decimal/missing index cols — per-row fallback
                    kvs: list[tuple[bytes, bytes]] = []
                    _index_kvs_slow(info, ix, col_infos, arrs, kind_list, scale_fix, handles, kvs)
                    mvcc.ingest(kvs, commit_ts)
    else:
        _bulk_load_rows(session, info, col_infos, col_ids, arrays, kind_list, scale_fix, pk_handle_pos, first_handle, indexes, commit_ts, batch)
    # semi-sync parity with the bulk engine: each ingest_run fsynced
    # locally; one wal_sync extends the ack to durable-on-standby
    session.store.wal_sync()
    session.store.bump_version([tablecodec.record_prefix(info.id)])
    session.cop.tiles.invalidate_table(info.id)
    return n


def _index_kvs_slow(info, ix, col_infos, arrs, kind_list, scale_fix, handles, kvs):
    from ..table.table import Table

    tbl = Table(info)
    n_tbl_cols = len(info.columns)
    offsets = [c.offset for c in col_infos]
    for i in range(len(handles)):
        full = [Datum.null()] * n_tbl_cols
        for off, arr, k, sf in zip(offsets, arrs, kind_list, scale_fix):
            full[off] = datum_for(k, arr[i], sf)
        for c in info.columns:
            if c.hidden and c.name == "_tidb_rowid":
                full[c.offset] = Datum.i(int(handles[i]))
        ikey, ival, _ = tbl.index_value_key(ix, full, int(handles[i]))
        kvs.append((ikey, ival))


def _bulk_load_rows(session, info, col_infos, col_ids, arrays, kind_list, scale_fix, pk_handle_pos, first_handle, indexes, commit_ts, batch):
    """Per-row fallback for kinds the vectorized encoder doesn't cover."""
    from ..table.table import Table

    tbl = Table(info)
    offsets = [c.offset for c in col_infos]
    n_tbl_cols = len(info.columns)
    n = len(arrays[0])
    kvs = []
    for lo in range(0, n, batch):
        hi = min(lo + batch, n)
        for i in range(lo, hi):
            datums = [
                datum_for(k, arr[i], sf)
                for arr, k, sf in zip(arrays, kind_list, scale_fix)
            ]
            handle = datums[pk_handle_pos].to_int() if pk_handle_pos is not None else first_handle + i
            kvs.append((tablecodec.record_key(info.id, handle), encode_row(col_ids, datums)))
            if indexes:
                full = [Datum.null()] * n_tbl_cols
                for off, d in zip(offsets, datums):
                    full[off] = d
                for c in info.columns:
                    if c.hidden and c.name == "_tidb_rowid":
                        full[c.offset] = Datum.i(handle)
                for ix in indexes:
                    ikey, ival, _ = tbl.index_value_key(ix, full, handle)
                    kvs.append((ikey, ival))
        session.store.mvcc.ingest(kvs, commit_ts)
        kvs = []
