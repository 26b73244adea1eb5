"""Telecommand TCP interface.

Reference parity: TcpCmdInterface (src/core/receiver/tcp_cmd_interface.cc) —
a line-oriented TCP server accepting `status`, `standby`, `reset`,
`coldstart`, `warmstart`, `hotstart <UTC> <lat> <lon> <h>` and mapping them
onto receiver control actions (register_functions :58-66, hotstart parse
:173-212).
"""

from __future__ import annotations

import socket
import threading


class TelecommandServer:
    """Thread-per-connection command server driving a Receiver-like object.

    The target must expose: `status() -> str`, and accept control flags
    `standby`, `reset`, `cold_start`, `warm_start(lat, lon, h, tow)`.
    """

    def __init__(self, target, host: str = "127.0.0.1", port: int = 3333):
        self._target = target
        self._addr = (host, port)
        self._sock: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._running = False

    # ---------------- command handlers (register_functions analogue) -----

    def _cmd_status(self, _args: list[str]) -> str:
        fn = getattr(self._target, "status", None)
        return fn() if fn else "OK"

    def _cmd_standby(self, _args: list[str]) -> str:
        if hasattr(self._target, "standby"):
            self._target.standby()
        return "OK"

    def _cmd_reset(self, _args: list[str]) -> str:
        if hasattr(self._target, "reset"):
            self._target.reset()
        return "OK"

    def _cmd_coldstart(self, _args: list[str]) -> str:
        if hasattr(self._target, "cold_start"):
            self._target.cold_start()
        return "OK"

    def _cmd_warmstart(self, args: list[str]) -> str:
        return self._start_with_position(args, "warm_start")

    def _cmd_hotstart(self, args: list[str]) -> str:
        return self._start_with_position(args, "hot_start")

    def _start_with_position(self, args: list[str], method: str) -> str:
        # format (ref :173-212): <dd/mm/yyyy HH:MM:SS> <lat> <lon> <height>
        if len(args) < 5:
            return "ERROR: expected <date> <time> <lat> <lon> <height>"
        try:
            lat, lon, h = (float(a) for a in args[2:5])
        except ValueError:
            return "ERROR: bad coordinates"
        fn = getattr(self._target, method, None)
        if fn:
            fn(lat, lon, h, f"{args[0]} {args[1]}")
        return "OK"

    # ---------------- server loop ----------------

    def serve_once(self, line: str) -> str:
        """Dispatch one command line (exposed for tests)."""
        parts = line.strip().split()
        if not parts:
            return ""
        handlers = {
            "status": self._cmd_status,
            "standby": self._cmd_standby,
            "reset": self._cmd_reset,
            "coldstart": self._cmd_coldstart,
            "warmstart": self._cmd_warmstart,
            "hotstart": self._cmd_hotstart,
        }
        fn = handlers.get(parts[0].lower())
        if fn is None:
            return f"ERROR: unknown command {parts[0]}"
        return fn(parts[1:])

    def start(self) -> int:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(self._addr)
        self._sock.listen(2)
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self._sock.getsockname()[1]

    def _loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with conn:
                f = conn.makefile("rw")
                for line in f:
                    resp = self.serve_once(line)
                    f.write(resp + "\n")
                    f.flush()
                    if not self._running:
                        break

    def stop(self) -> None:
        self._running = False
        if self._sock:
            self._sock.close()
