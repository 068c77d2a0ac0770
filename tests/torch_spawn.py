"""Spawned gloo worlds for the tests: ports to listen on, and the ranks
run and stopped together. Imports neither JAX nor the port.

A world's ranks listen on ports that the parent drew earlier, sometimes
minutes earlier. A port drawn by binding port 0 comes from Linux's
ephemeral range (32768-60999), from which the kernel also picks the
source port of every outgoing connection, and the other test workers'
gloo worlds open many: by the time a rank listens, its port may be
taken, its listen fails with EADDRINUSE, and its peers wait for it until
their join times out (one run of the tests hung for 1,838.5 s so). So
:func:`free_ports` draws below that range, and :func:`spawn` stops a
world's other ranks as soon as one fails.
"""

from __future__ import annotations

import multiprocessing
import random
import socket
import time


def free_ports(k: int) -> list[int]:
    """``k`` distinct ports in 20000-32767, each free when drawn."""
    rng = random.Random()
    ports = []
    while len(ports) < k:
        port = rng.randrange(20000, 32768)
        if port in ports:
            continue
        with socket.socket() as s:
            try:
                s.bind(('127.0.0.1', port))
            except OSError:
                continue
        ports.append(port)
    return ports


def free_port() -> int:
    """One port of :func:`free_ports`."""
    return free_ports(1)[0]


def spawn(target, n: int, *args, timeout: float) -> list[int]:
    """``target(rank, n, *args)`` in ``n`` spawned processes, all of which
    must exit with 0 within ``timeout`` seconds; the others are stopped as
    soon as one fails (they would wait for it). Returns the exit codes,
    all 0."""
    ctx = multiprocessing.get_context('spawn')
    procs = [ctx.Process(target=target, args=(r, n, *args))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline \
            and all(p.exitcode in (None, 0) for p in procs):
        time.sleep(0.2)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * n, codes
    return codes
