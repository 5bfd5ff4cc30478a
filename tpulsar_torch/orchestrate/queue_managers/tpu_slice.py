"""Accelerator-host queue backend: fan beam jobs out to a pool of
hosts — counterpart of tpulsar/orchestrate/queue_managers/tpu_slice.py
(a copy).  It keeps the JAX package's registered name, ``tpu_slice``,
so one configuration file means the same thing to both packages.

The replacement for the reference's cluster backends (SURVEY.md
section 5.8): each "queue slot" is a host with its card, reachable by
a launcher command; one beam search occupies one slot.  Beams are
independent, so the network carries only the job launch and the
result return; each beam's search runs on its host's card.

The launcher command is pluggable (default: ssh).  Each slot runs the
same search-job entry as the local backend, with the DATAFILES/OUTDIR
environment contract; results land on the shared filesystem exactly
like the reference's rsync-based return path (bin/search.py:188-192).
"""

from __future__ import annotations

import os
import shlex
import subprocess
import threading
import uuid

from tpulsar_torch.orchestrate.queue_managers import SubmitRegistry


class TPUSliceManager:
    """Restart-safe: each launch wraps the remote command so its exit
    code lands in an `<qid>.exit` marker on the shared filesystem.
    Liveness and error state are derived from the marker + stderr
    file, not from in-memory Popen handles, so a JobPool daemon
    restart neither kills nor double-submits in-flight beams (the
    same restart-from-durable-state property the reference gets from
    queue_id polling, job.py:131-135)."""

    def __init__(self, hosts: list[str],
                 launcher: str = "ssh {host} {cmd}",
                 remote_cmd: str = "python -m tpulsar_torch.cli.search_job",
                 env_extra: dict | None = None,
                 state_file: str | None = None,
                 lost_job_timeout_s: float = 24 * 3600.0,
                 qid_flag: bool | None = None):
        """hosts: accelerator host addresses, one concurrent beam each.
        launcher: template with {host} and {cmd} placeholders.
        lost_job_timeout_s: a restart-orphaned job whose exit marker
        never appears is declared lost (and its slot freed) after this
        long — the guard against a host that died before the wrapper
        could write the marker.
        qid_flag: append `--qid <qid>` to remote_cmd so the WORKER's
        command line carries the qid (lets delete() pkill the whole
        remote job, not just the launcher wrapper).  None = auto:
        enabled for the framework's own search_job worker, which
        accepts the flag; a custom remote_cmd gets the qid via the
        TPULSAR_QID environment variable instead unless it opts in."""
        if not hosts:
            raise ValueError("TPUSliceManager needs at least one host")
        self.hosts = list(hosts)
        self.launcher = launcher
        self.remote_cmd = remote_cmd
        self.env_extra = env_extra or {}
        self.lost_job_timeout_s = lost_job_timeout_s
        self.qid_flag = (qid_flag if qid_flag is not None
                         else "tpulsar_torch.cli.search_job" in remote_cmd)
        self._lock = threading.Lock()
        self._procs: dict[str, subprocess.Popen] = {}
        self._done: set[str] = set()   # qids observed finished (cache)
        self._registry = SubmitRegistry(state_file)

    def _free_host(self) -> str | None:
        busy = {self._registry.get(qid, "host")
                for qid in self._live_qids()}
        for h in self.hosts:
            if h not in busy:
                return h
        return None

    def _live_qids(self) -> list[str]:
        with self._lock:
            qids = list(self._procs)
            done = set(self._done)
        # registry entries from a previous daemon life are live until
        # their exit marker appears; qids already seen finished are
        # skipped without touching the filesystem again
        for qid in self._registry.all_ids():
            if qid not in qids and qid not in done:
                qids.append(qid)
        return [qid for qid in qids
                if qid not in done and self.is_running(qid)]

    def submit(self, datafiles: list[str], outdir: str, job_id: int) -> str:
        host = self._free_host()
        if host is None:
            from tpulsar_torch.orchestrate.queue_managers import (
                QueueManagerNonFatalError)
            raise QueueManagerNonFatalError("no free accelerator host")
        os.makedirs(outdir, exist_ok=True)
        qid = f"tpu-{job_id}-{uuid.uuid4().hex[:8]}"
        errpath = os.path.join(outdir, f"{qid}.stderr")
        exitpath = os.path.join(outdir, f"{qid}.exit")
        envs = {"DATAFILES": ";".join(datafiles), "OUTDIR": outdir,
                **self.env_extra}
        env_prefix = " ".join(f"{k}={shlex.quote(v)}"
                              for k, v in envs.items())
        # --qid stamps the qid into the WORKER's command line (not
        # just the wrapper's), so delete() can kill the whole remote
        # job with pkill -f <qid>; only the framework's own worker is
        # known to accept the flag — a custom remote_cmd gets it via
        # env instead (kill then only reaches the wrapper)
        if self.qid_flag:
            cmd = f"{self.remote_cmd} --qid {qid}"
        else:
            cmd = f"TPULSAR_QID={qid} {self.remote_cmd}"
        inner = (f"{env_prefix} {cmd}; "
                 f"echo $? > {shlex.quote(exitpath)}")
        full = self.launcher.format(host=host, cmd=shlex.quote(inner))
        with open(errpath, "wb") as errfh:
            proc = subprocess.Popen(shlex.split(full),
                                    stdout=subprocess.DEVNULL,
                                    stderr=errfh)
        with self._lock:
            self._procs[qid] = proc
        self._registry.put(qid, host=host, errpath=errpath,
                           exitpath=exitpath)
        return qid

    def can_submit(self) -> bool:
        return self._free_host() is not None

    def _exit_code(self, queue_id: str) -> int | None:
        exitpath = self._registry.get(queue_id, "exitpath")
        if exitpath and os.path.exists(exitpath):
            try:
                with open(exitpath) as fh:
                    return int(fh.read().strip() or 1)
            except (OSError, ValueError):
                return 1
        return None

    def is_running(self, queue_id: str) -> bool:
        if self._exit_code(queue_id) is not None:
            with self._lock:
                self._done.add(queue_id)
            return False
        with self._lock:
            proc = self._procs.get(queue_id)
        if proc is not None:
            if proc.poll() is None:
                return True
            # launcher exited without writing the marker: launch failed
            self._mark_done(queue_id)
            return False
        # No handle (daemon restarted): still running until the marker
        # appears — bounded by the lost-job timeout so a host that died
        # before the wrapper ran cannot leak its slot forever.
        if not self._registry.known(queue_id):
            return False
        import time
        submitted = self._registry.get(queue_id, "ts", 0.0)
        if time.time() - submitted > self.lost_job_timeout_s:
            self._mark_done(queue_id, code="137")
            return False
        return True

    def _mark_done(self, queue_id: str, code: str = "1") -> None:
        """Write the exit marker on the job's behalf (launcher death /
        operator delete / lost-job timeout) so the state converges."""
        exitpath = self._registry.get(queue_id, "exitpath")
        if exitpath and not os.path.exists(exitpath):
            try:
                with open(exitpath, "w") as fh:
                    fh.write(code + "\n")
            except OSError:
                pass
        with self._lock:
            self._done.add(queue_id)

    def delete(self, queue_id: str) -> bool:
        with self._lock:
            proc = self._procs.get(queue_id)
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
            # terminating the LOCAL launcher does not reliably kill
            # the REMOTE command (ssh without a pty leaves it
            # running); chase it down like the handle-less case
            if self._exit_code(queue_id) is None:
                self._remote_kill(queue_id)
        elif proc is None:
            if not self._registry.known(queue_id):
                return False
            if self._exit_code(queue_id) is None:
                # Restart-orphaned job (registry-known, no Popen): the
                # local launcher is gone but the REMOTE search may
                # still be running.  Kill it through the launcher —
                # writing only a local marker would free the slot
                # while the remote process keeps the card busy
                # (double-booking; round-1 advisor finding).  If the
                # host is unreachable, keep the slot reserved: the
                # exit marker or the lost-job timeout converges it.
                if not self._remote_kill(queue_id):
                    return False
        # the killed (or already-dead) wrapper never writes its marker
        self._mark_done(queue_id, code="143")
        return True

    def _remote_kill(self, queue_id: str) -> bool:
        """Best-effort pkill of the remote job by its qid stamp.
        True when the kill command ran (rc 0 = killed, rc 1 = no such
        process, i.e. already dead); False when the host could not be
        reached."""
        host = self._registry.get(queue_id, "host")
        if not host:
            return False
        # bracket the first character so the kill command's own
        # cmdline (which contains the qid) does not match the pattern
        # and pkill its own launcher shell
        pattern = f"[{queue_id[0]}]{queue_id[1:]}"
        cmd = self.launcher.format(
            host=host, cmd=shlex.quote(f"pkill -TERM -f {pattern}"))
        try:
            res = subprocess.run(shlex.split(cmd), timeout=30,
                                 capture_output=True)
            return res.returncode in (0, 1)
        except (subprocess.TimeoutExpired, OSError):
            return False

    def status(self) -> tuple[int, int]:
        return 0, len(self._live_qids())

    def had_errors(self, queue_id: str) -> bool:
        if not self._registry.known(queue_id):
            return True
        code = self._exit_code(queue_id)
        if code is None:
            with self._lock:
                proc = self._procs.get(queue_id)
            if proc is not None and proc.poll() not in (0, None):
                return True     # launcher itself failed
        elif code != 0:
            return True
        errpath = self._registry.get(queue_id, "errpath")
        return bool(errpath and os.path.exists(errpath)
                    and os.path.getsize(errpath) > 0)

    def get_errors(self, queue_id: str) -> str:
        parts = []
        code = self._exit_code(queue_id)
        if code not in (0, None):
            parts.append(f"exit code {code}")
        with self._lock:
            proc = self._procs.get(queue_id)
        if code is None and proc is not None \
                and proc.poll() not in (0, None):
            parts.append(f"launcher exit code {proc.poll()}")
        errpath = self._registry.get(queue_id, "errpath")
        if errpath and os.path.exists(errpath) and os.path.getsize(errpath):
            with open(errpath, errors="replace") as fh:
                parts.append(fh.read())
        return "\n".join(parts)
