"""The port's SQL front end (tidb_tpu_torch/parser/) against the
reference's, on the CPU.

The same statement text goes through both parsers, and the ASTs are held
equal by a dataclass walk: class names, every field, decimals by their
string. A statement the reference refuses must raise the same error class
with the same message in the port (ParseError for a syntax error).

The statements:
  * every SQL string literal that the reference's own tests hand to
    `parse` / `parse_one` / `Session.execute` / `must_query` — the
    SELECT, DDL, DML, SET, SHOW, ADMIN, resource-group and hint forms its
    parser accepts (one case per test file);
  * the `QUERIES` of tests/test_plan_golden.py;
  * every SQL constant of tidb_tpu_torch/models/tpch.py;
  * a hand-written list of the statement forms (below), and a list of
    statements the parser refuses.
"""

import ast as pyast
import dataclasses
import glob
import os

import pytest

from tidb_tpu import errors as r_errors
from tidb_tpu.parser import parse as r_parse
from tidb_tpu.parser.lexer import tokenize as r_tokenize

from tidb_tpu_torch import errors as p_errors
from tidb_tpu_torch.models import tpch
from tidb_tpu_torch.parser import parse as p_parse
from tidb_tpu_torch.parser.lexer import tokenize as p_tokenize
from tidb_tpu_torch.utils.stmtstats import normalize_sql, sql_digest

HERE = os.path.dirname(os.path.abspath(__file__))
CALLS = ("parse", "parse_one", "execute", "must_query")


def harvested() -> dict[str, list[str]]:
    """{test file: the SQL literals its calls pass} over the reference's
    tests."""
    out = {}
    for path in sorted(glob.glob(os.path.join(HERE, "test_*.py"))):
        name = os.path.basename(path)
        if name.startswith("test_torch_"):
            continue
        found = []
        for node in pyast.walk(pyast.parse(open(path, encoding="utf-8").read(), path)):
            if not isinstance(node, pyast.Call) or not node.args:
                continue
            fn = node.func
            called = fn.attr if isinstance(fn, pyast.Attribute) else getattr(fn, "id", None)
            if called not in CALLS:
                continue
            try:
                v = pyast.literal_eval(node.args[0])
            except (ValueError, SyntaxError, TypeError):
                continue
            if isinstance(v, str) and v not in found:
                found.append(v)
        if found:
            out[name] = found
    return out


HARVEST = harvested()

FORMS = [
    # DDL
    "CREATE TABLE t2 (id BIGINT PRIMARY KEY AUTO_INCREMENT, a DECIMAL(12,2) NOT NULL DEFAULT 0.50, "
    "b VARCHAR(32) COLLATE utf8mb4_general_ci, c DATETIME(3), d ENUM('x','y'), KEY ia (a), UNIQUE KEY ub (b))",
    "CREATE TABLE IF NOT EXISTS p (k INT PRIMARY KEY, v INT) PARTITION BY RANGE (k) "
    "(PARTITION p0 VALUES LESS THAN (100), PARTITION p1 VALUES LESS THAN MAXVALUE)",
    "CREATE TABLE h (k INT, v INT) PARTITION BY HASH (k) PARTITIONS 4",
    "CREATE INDEX ix ON t (a, b)",
    "ALTER TABLE t DROP COLUMN e",
    "ALTER TABLE t ADD INDEX ie (e), DROP INDEX ia",
    "ALTER TABLE t MODIFY COLUMN b BIGINT",
    "ALTER TABLE t RENAME TO t3",
    "DROP TABLE IF EXISTS t, u",
    "DROP INDEX ix ON t",
    "TRUNCATE TABLE t",
    "CREATE VIEW v AS SELECT a, SUM(b) FROM t GROUP BY a",
    "CREATE OR REPLACE VIEW v (x, y) AS SELECT a, b FROM t",
    "CREATE DATABASE IF NOT EXISTS db2",
    "DROP DATABASE db2",
    "CREATE SEQUENCE seq START WITH 5 INCREMENT BY 2",
    # DML
    "INSERT INTO t (id, a) VALUES (1, 2), (3, DEFAULT)",
    "INSERT INTO t VALUES (1, 'x') ON DUPLICATE KEY UPDATE a = VALUES(a) + 1",
    "INSERT IGNORE INTO t SELECT * FROM u WHERE id > 3",
    "REPLACE INTO t (id, a) VALUES (1, 2)",
    "UPDATE t SET a = a + 1, b = 'y' WHERE id IN (1, 2, 3) ORDER BY id LIMIT 2",
    "UPDATE t JOIN u ON t.id = u.id SET t.a = u.x",
    "DELETE FROM t WHERE a BETWEEN 1 AND 5 LIMIT 10",
    "DELETE t FROM t JOIN u ON t.id = u.id WHERE u.x IS NULL",
    "LOAD DATA LOCAL INFILE '/tmp/x.csv' INTO TABLE t FIELDS TERMINATED BY ',' IGNORE 1 LINES",
    # SET and transactions
    "SET @@session.tidb_cop_engine = 'host'",
    "SET GLOBAL tidb_server_memory_limit = 1073741824",
    "SET tidb_tpu_mpp_fused = OFF, @x = 5",
    "SET NAMES utf8mb4",
    "BEGIN",
    "START TRANSACTION",
    "COMMIT",
    "ROLLBACK",
    # resource groups
    "CREATE RESOURCE GROUP IF NOT EXISTS rg1 RU_PER_SEC = 1000 PRIORITY = HIGH BURSTABLE",
    "ALTER RESOURCE GROUP rg1 QUERY_LIMIT = (EXEC_ELAPSED = '1m30s', ACTION = KILL, WATCH = '10s')",
    "ALTER RESOURCE GROUP rg1 QUERY_LIMIT = (PROCESSED_ROWS = 1000, ACTION = COOLDOWN)",
    "DROP RESOURCE GROUP IF EXISTS rg1",
    "SET RESOURCE GROUP rg1",
    # hints
    "SELECT /*+ USE_INDEX(t, ia) */ id FROM t WHERE a > 1",
    "SELECT /*+ IGNORE_INDEX(t, ia) STRAIGHT_JOIN() */ * FROM t JOIN u ON t.a = u.id",
    "SELECT /*+ SET_VAR(tidb_cop_engine='host') MAX_EXECUTION_TIME(1000) */ COUNT(*) FROM t",
    # the rest
    "EXPLAIN ANALYZE SELECT * FROM t WHERE id = 1",
    "EXPLAIN FORMAT = 'brief' SELECT 1",
    "TRACE SELECT 1",
    "ANALYZE TABLE t, u",
    "SHOW CREATE TABLE t",
    "SHOW VARIABLES LIKE 'tidb_%'",
    "SHOW FULL PROCESSLIST",
    "ADMIN SHOW DDL JOBS",
    "ADMIN CHECK TABLE t",
    "PREPARE s1 FROM 'SELECT * FROM t WHERE id = ?'",
    "EXECUTE s1 USING @x",
    "DEALLOCATE PREPARE s1",
    "KILL QUERY 5",
    "USE test",
    "LOCK TABLES t READ, u WRITE",
    "UNLOCK TABLES",
    "SPLIT TABLE t BETWEEN (0) AND (1000) REGIONS 4",
    "WITH RECURSIVE r (n) AS (SELECT 1 UNION ALL SELECT n + 1 FROM r WHERE n < 5) SELECT * FROM r",
    "SELECT SUM(a) OVER (ORDER BY b ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) FROM t",
    "SELECT CAST(a AS DECIMAL(10, 3)), CONVERT(b, CHAR), a DIV 2, -a, NOT a, a IS NOT TRUE FROM t",
    "SELECT 1e3, .5, 0x1F, X'0a', 'it''s', \"dq\", 12345678901234567890, 1.000 FROM dual",
    "SELECT * FROM t WHERE c LIKE 'a%' ESCAPE '!' AND c REGEXP '^x' AND a IN (SELECT id FROM u)",
    "SELECT DATE_ADD(c, INTERVAL 3 DAY), EXTRACT(YEAR FROM c), CASE a WHEN 1 THEN 'x' ELSE 'y' END FROM t",
    "SELECT * FROM t AS OF TIMESTAMP '2024-01-01 00:00:00' WHERE id = 1 FOR UPDATE",
    "SELECT a FROM t UNION SELECT b FROM u EXCEPT SELECT c FROM v INTERSECT SELECT d FROM w",
    "SELECT * FROM t NATURAL JOIN u LEFT OUTER JOIN v USING (id) CROSS JOIN w",
    "SELECT 1; SELECT 2;; SELECT 3",
    "",
    "SELECT a FROM t LIMIT -1",
    "ALTER TABLE t ADD COLUMN e INT DEFAULT 7",
    "CREATE UNIQUE INDEX ux ON t (c)",
    "RENAME TABLE a TO b",
]

REFUSED = [
    "SELECT FROM WHERE",
    "FROBNICATE ALL THE THINGS",
    "SELECT * FROM",
    "SELECT (1",
    "SELECT 'unterminated",
    "INSERT INTO t VALUES",
    "CREATE TABLE t (",
    "SELECT 1 SELECT 2",
    "ALTER RESOURCE GROUP rg1 QUERY_LIMIT = (ACTION = EXPLODE)",
    "ALTER RESOURCE GROUP rg1 QUERY_LIMIT = (EXEC_ELAPSED = 'soon', ACTION = KILL)",
    "SELECT @",
    "SELECT 0b101, b'101'",
    "CREATE UNIQUE INDEX ux ON t (c(10))",
    "ALTER TABLE t ADD COLUMN e INT DEFAULT 7 AFTER a",
    "RENAME TABLE a TO b, c TO d",
    "SELECT a, ROW_NUMBER() OVER w FROM t WINDOW w AS (PARTITION BY b ORDER BY a)",
]


def tpch_sql() -> list[str]:
    out = []
    for name in sorted(vars(tpch)):
        v = getattr(tpch, name)
        if isinstance(v, str) and v.lstrip().split(" ", 1)[0].upper() in ("SELECT", "CREATE", "WITH"):
            out.append(v.format(lo=100, hi=5000) if "{lo}" in v else v)
    return out


def desc(x):
    """A package-free description of an AST: dataclasses by class name and
    fields, decimals by their string, floats by repr (NaN-safe)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, tuple((f.name, desc(getattr(x, f.name))) for f in dataclasses.fields(x)))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [desc(v) for v in x])
    if isinstance(x, dict):
        return ("dict", sorted((repr(k), desc(v)) for k, v in x.items()))
    if isinstance(x, float):
        return ("float", repr(x))
    if x is None or isinstance(x, (str, int, bool, bytes)):
        return x
    return (type(x).__name__, str(x))


def outcome(parse, sql):
    try:
        return ("ok", desc(parse(sql)))
    except Exception as e:  # noqa: BLE001 — the error is the outcome compared
        return ("err", type(e).__name__, str(e))


def assert_same(sqls):
    assert sqls
    for sql in sqls:
        want, got = outcome(r_parse, sql), outcome(p_parse, sql)
        assert got == want, f"{sql!r}\nref:  {want}\nport: {got}"


@pytest.mark.parametrize("source", sorted(HARVEST))
def test_every_statement_of_the_reference_tests_parses_the_same(source):
    assert_same(HARVEST[source])


def test_the_golden_plan_queries_parse_the_same():
    import test_plan_golden

    assert_same(test_plan_golden.QUERIES)


def test_every_tpch_constant_parses_the_same():
    sqls = tpch_sql()
    assert len(sqls) >= 15
    assert_same(sqls)
    assert all(outcome(p_parse, s)[0] == "ok" for s in sqls)


@pytest.mark.parametrize("i", range(len(FORMS)))
def test_statement_forms_parse_the_same(i):
    assert outcome(r_parse, FORMS[i])[0] == "ok", "the reference refuses this form"
    assert_same([FORMS[i]])


@pytest.mark.parametrize("i", range(len(REFUSED)))
def test_refused_statements_raise_the_same_error(i):
    want = outcome(r_parse, REFUSED[i])
    assert want[0] == "err"
    assert_same([REFUSED[i]])


def test_a_syntax_error_is_the_ports_parse_error_with_code_1064():
    with pytest.raises(p_errors.ParseError) as e:
        p_parse("SELECT FROM WHERE")
    assert e.value.code == r_errors.ParseError.code == 1064
    assert isinstance(e.value, p_errors.TiDBError)


def test_tokens_and_digests_are_the_same():
    """The lexer's tokens, and the statement digest and literal-free text
    built on them (utils/stmtstats.py, the runaway watch list's key)."""
    from tidb_tpu.utils.stmtstats import normalize_sql as r_norm, sql_digest as r_digest

    for sql in FORMS + tpch_sql():
        assert [(t.kind, t.text) for t in p_tokenize(sql)] == [(t.kind, t.text) for t in r_tokenize(sql)]
        assert sql_digest(sql) == r_digest(sql) and normalize_sql(sql) == r_norm(sql)


def test_runaway_durations_read_the_same():
    from tidb_tpu.sched import runaway as r_runaway

    from tidb_tpu_torch.sched import runaway as p_runaway

    assert p_runaway.ACTIONS == r_runaway.ACTIONS
    for s in ("800ms", "10s", "5m", "1h", "1m30s", "2.5", "90"):
        ms = p_runaway.parse_duration_ms(s)
        assert ms == r_runaway.parse_duration_ms(s)
        assert p_runaway.format_duration(ms) == r_runaway.format_duration(ms)
    for bad in ("soon", "1x", ""):
        with pytest.raises(ValueError):
            p_runaway.parse_duration_ms(bad)
    spec = {"exec_elapsed_ms": 90_000.0, "action": "kill", "watch_ms": 10_000.0}
    assert p_runaway.QueryLimit.from_spec(spec).render() == r_runaway.QueryLimit.from_spec(spec).render()


def test_the_sysvar_registry_is_the_references():
    from tidb_tpu.session import vars as r_vars

    from tidb_tpu_torch.session import vars as p_vars

    assert list(p_vars.SYSVARS) == list(r_vars.SYSVARS)
    for name, sv in r_vars.SYSVARS.items():
        assert dataclasses.asdict(p_vars.SYSVARS[name]) == dataclasses.asdict(sv)
    assert p_vars.DEFAULT_VARS == r_vars.DEFAULT_VARS
    for name, value, scope in (("tidb_tpu_mpp_fused", "0", "global"), ("tidb_opt_join_reorder_threshold", "7", None),
                               ("tidb_cop_engine", "HOST", None)):
        assert p_vars.set_var(name, value, scope=scope) == r_vars.set_var(name, value, scope=scope)
    with pytest.raises(ValueError, match="GLOBAL variable"):
        p_vars.set_var("tidb_tpu_mpp_fused", "0")
