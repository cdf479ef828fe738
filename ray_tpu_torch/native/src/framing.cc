// Native frame I/O for the RPC plane (ray_tpu_torch/cluster/rpc.py), a copy
// of ray_tpu/native/src/framing.cc: the frames are the same bytes, so one
// side may be either library.
//
// Reference analog: the gRPC/C++ transport under src/ray/rpc/ — here the
// wire format stays the framework's length-prefixed frames, but the
// receive hot loop (read 4-byte length, then exactly `len` payload
// bytes) runs in C with the GIL released: no Python-level recv loop, no
// bytes concatenation, one malloc per frame. Enabled from Python with
// RAY_TPU_NATIVE_FRAMING=1 (see rpc.py RpcClient's reader and writer
// threads); it stays opt-in, as in the reference.
//
// All waits are BOUNDED polls (timeout_ms; <0 = wait forever). The
// previous poll(-1) meant a peer that stalled mid-frame wedged the
// caller for good — and frame_write runs on the client's one writer
// thread, so one stalled peer froze every call on that connection.

#include <arpa/inet.h>
#include <cerrno>
#include <cstdlib>
#include <cstring>
#include <sys/socket.h>
#include <poll.h>
#include <sys/uio.h>
#include <unistd.h>

namespace {

// Wait for fd readiness. Returns 0 ready, 1 timed out, -1 error.
// timeout_ms < 0 waits forever (legacy behavior).
int wait_fd(int fd, short events, int timeout_ms) {
  struct pollfd pfd = {fd, events, 0};
  for (;;) {
    int r = poll(&pfd, 1, timeout_ms);
    if (r > 0) return 0;
    if (r == 0) return 1;  // expired
    if (errno == EINTR) continue;  // retry with the full bound: simple,
                                   // and signals here are rare
    return -1;
  }
}

// Read exactly n bytes; *consumed reports progress so the caller can
// distinguish "idle, nothing arrived" from "stalled mid-frame".
// Returns 0 on success, -1 on EOF/error, 1 on poll timeout.
//
// recv always uses MSG_DONTWAIT: the fds rpc.py hands over are usually
// BLOCKING sockets (settimeout(None)), and a blocking recv would park
// inside the kernel where no timeout can reach it. Readiness waiting is
// poll()'s job here, with the caller's bound.
int read_exact(int fd, unsigned char* buf, size_t n, int timeout_ms,
               size_t* consumed) {
  size_t got = 0;
  while (got < n) {
    ssize_t r = recv(fd, buf + got, n - got, MSG_DONTWAIT);
    if (r == 0) {
      *consumed = got;
      return -1;  // orderly EOF
    }
    if (r < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        int w = wait_fd(fd, POLLIN, timeout_ms);
        if (w == 0) continue;
        *consumed = got;
        return w;  // 1 = timeout, -1 = poll error
      }
      *consumed = got;
      return -1;
    }
    got += static_cast<size_t>(r);
  }
  *consumed = got;
  return 0;
}

}  // namespace

extern "C" {

// Read one frame, waiting at most timeout_ms at each blocking point
// (<0 = forever). On success returns the payload length (>= 0) and sets
// *out to a malloc'd buffer the caller releases with frame_free.
// Returns -1 on EOF / connection error / a MID-FRAME stall past the
// bound (the peer wedged with half a frame on the wire: the connection
// is unrecoverable — resyncing the length-prefixed stream is not
// possible), -2 on allocation failure / oversized frame (> 2^31,
// matching rpc.py MAX_FRAME), -3 on an IDLE timeout (no header byte
// arrived: nothing consumed, safe to retry — the Python loop uses this
// to re-check its shutdown flag).
long frame_read(int fd, unsigned char** out, int timeout_ms) {
  unsigned char hdr[4];
  size_t consumed = 0;
  int rc = read_exact(fd, hdr, 4, timeout_ms, &consumed);
  if (rc == 1) return consumed == 0 ? -3 : -1;
  if (rc != 0) return -1;
  uint32_t len = ntohl(*reinterpret_cast<uint32_t*>(hdr));
  if (len > (1u << 31)) return -2;
  unsigned char* buf = static_cast<unsigned char*>(malloc(len ? len : 1));
  if (buf == nullptr) return -2;
  rc = read_exact(fd, buf, len, timeout_ms, &consumed);
  if (rc != 0) {  // mid-frame timeout or error: either way the stream
    free(buf);    // is desynced — surface a connection error
    return -1;
  }
  *out = buf;
  return static_cast<long>(len);
}

void frame_free(unsigned char* p) { free(p); }

// Write header + payload with one writev (no Python-side concat copy).
// Returns 0 on success, -1 on connection error OR a stalled peer
// (socket unwritable for timeout_ms; <0 waits forever), -2 on
// oversized frame (> 2^31, matching the read-side / Python MAX_FRAME
// bound — silent 32-bit truncation would desync the peer's frame
// parser). A timeout mid-write leaves a partial frame on the wire;
// the caller must treat the connection as dead (rpc.py does: OSError
// -> RpcError -> reconnect), never retry the same frame.
int frame_write(int fd, const unsigned char* data, unsigned long len,
                int timeout_ms) {
  if (len > (1ul << 31)) return -2;
  unsigned char hdr[4];
  *reinterpret_cast<uint32_t*>(hdr) = htonl(static_cast<uint32_t>(len));
  struct iovec iov[2];
  size_t total = 4 + len;
  size_t sent = 0;
  while (sent < total) {
    // MSG_DONTWAIT everywhere (see read_exact): a blocking fd must not
    // park the writer in the kernel beyond the poll bound
    ssize_t r;
    if (sent < 4) {
      iov[0].iov_base = hdr + sent;
      iov[0].iov_len = 4 - sent;
      iov[1].iov_base = const_cast<unsigned char*>(data);
      iov[1].iov_len = len;
      struct msghdr msg = {};
      msg.msg_iov = iov;
      msg.msg_iovlen = 2;
      r = sendmsg(fd, &msg, MSG_DONTWAIT);
    } else {
      r = send(fd, data + (sent - 4), total - sent, MSG_DONTWAIT);
    }
    if (r < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        if (wait_fd(fd, POLLOUT, timeout_ms) == 0) continue;
        return -1;  // stalled peer or poll error: connection is dead
      }
      return -1;
    }
    sent += static_cast<size_t>(r);
  }
  return 0;
}

}  // extern "C"
