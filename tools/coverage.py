#!/usr/bin/env python
"""Statement-coverage harness — the Tcov analogue.

The reference ships its own coverage tool (``Tcov/``: a source rewriter
inserting counters at every statement, ``gbcover_edit.m``).  This
framework's equivalent instruments at runtime with ``sys.monitoring``
(PEP 669, low overhead) restricted to ``graphblas_tpu/``, runs the test
suite, and reports per-module executed/executable line percentages.

Usage:  python tools/coverage.py [pytest args...]
        (default: the fast core test files)
"""

import os
import sys
import sysconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "graphblas_tpu")
sys.path.insert(0, ROOT)

executed = {}  # filename -> set of line numbers

try:
    mon = sys.monitoring
    TOOL = mon.COVERAGE_ID
    mon.use_tool_id(TOOL, "gbtpu-cov")

    def on_line(code, line):
        fn = code.co_filename
        if fn.startswith(PKG):
            executed.setdefault(fn, set()).add(line)
        else:
            return mon.DISABLE

    mon.register_callback(TOOL, mon.events.LINE, on_line)
    mon.set_events(TOOL, mon.events.LINE)
except AttributeError:  # pragma: no cover - pre-3.12 fallback
    def tracer(frame, event, arg):
        if event == "line":
            fn = frame.f_code.co_filename
            if fn.startswith(PKG):
                executed.setdefault(fn, set()).add(frame.f_lineno)
        return tracer
    sys.settrace(tracer)


def executable_lines(path):
    """Lines bearing executable statements (dis-based, like Tcov's
    brace-counting but exact)."""
    import dis
    with open(path) as f:
        src = f.read()
    try:
        code = compile(src, path, "exec")
    except SyntaxError:
        return set()
    lines = set()
    stack = [code]
    while stack:
        co = stack.pop()
        for inst in dis.get_instructions(co):
            if inst.positions and inst.positions.lineno:
                lines.add(inst.positions.lineno)
        for const in co.co_consts:
            if hasattr(const, "co_code"):
                stack.append(const)
    return lines


def main():
    import pytest
    args = sys.argv[1:] or [
        "tests/test_mxm.py", "tests/test_ewise.py", "tests/test_reduce.py",
        "tests/test_assign.py", "tests/test_api.py", "-q", "-x",
    ]
    rc = pytest.main(args)

    if hasattr(sys, "monitoring"):
        sys.monitoring.set_events(sys.monitoring.COVERAGE_ID, 0)
    else:
        sys.settrace(None)

    print("\n=== graphblas_tpu statement coverage ===")
    total_exec = total_all = 0
    rows = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            alll = executable_lines(path)
            ran = executed.get(path, set()) & alll
            if not alll:
                continue
            rows.append((os.path.relpath(path, ROOT), len(ran), len(alll)))
            total_exec += len(ran)
            total_all += len(alll)
    for name, ran, allc in rows:
        print(f"{name:55s} {ran:5d}/{allc:<5d} {100*ran/allc:5.1f}%")
    print(f"{'TOTAL':55s} {total_exec:5d}/{total_all:<5d} "
          f"{100*total_exec/max(total_all,1):5.1f}%")
    sys.exit(rc)


if __name__ == "__main__":
    main()
