// Native UDP datagram engine (dual-stack).
//
// C++ implementation of the runtime's packet ingress/egress — the role
// the reference's rcv_thread + NetworkEngine ingress guards play
// (reference: src/dhtrunner.cpp:511-608 select loop over the v4+v6
// sockets + bounded queue; include/opendht/network_engine.h:424,519-523
// global/per-IP rate limits; src/network_engine.cpp:361-386 martian
// filter).
//
// Design: one engine owns a bound IPv4 socket and (optionally) an
// IPv6-only socket on the same port; one receiver thread polls both and
// timestamps datagrams into a fixed ring buffer.  Python drains the
// ring in batches (one ctypes call for many packets) instead of one
// recvfrom syscall + allocation per packet through the interpreter.
// Rate limiting and martian filtering run natively before a packet ever
// reaches Python.
//
// C ABI only (ctypes).  Addresses cross the ABI as
// (family u8, addr u8[16], port u16) — v4 uses the first 4 addr bytes.

#include <arpa/inet.h>
#include <array>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <netinet/in.h>
#include <poll.h>
#include <string>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

constexpr int MAX_PACKET = 1500;

double now_s() {
    return std::chrono::duration<double>(
        std::chrono::steady_clock::now().time_since_epoch()).count();
}

// sliding-window quota (reference: include/opendht/rate_limiter.h:26-48)
struct RateWindow {
    std::vector<double> hits;
    size_t quota;
    double period;
    RateWindow(size_t q = 0, double p = 1.0) : quota(q), period(p) {}
    bool limit(double now) {
        if (quota == 0) return true;           // disabled
        while (!hits.empty() && hits.front() < now - period)
            hits.erase(hits.begin());
        if (hits.size() >= quota) return false;
        hits.push_back(now);
        return true;
    }
};

struct Packet {
    double rx_time;
    uint8_t family;                            // 4 or 6
    uint8_t addr[16];                          // v4 in first 4 bytes
    uint16_t port;
    uint16_t len;
    uint8_t data[MAX_PACKET];
};

struct Engine {
    int fd4 = -1;
    int fd6 = -1;                              // <0 when v6 disabled
    uint16_t bound_port = 0;
    std::thread rcv;
    std::atomic<bool> running{false};

    std::vector<Packet> ring;
    size_t head = 0, tail = 0;                 // ring indices
    std::mutex mtx;
    std::condition_variable cv;                // signalled on enqueue

    RateWindow global_limit;
    std::unordered_map<std::string, RateWindow> ip_limits;  // 16-byte key
    size_t per_ip_quota = 0;
    double last_prune = 0.0;
    bool drop_martian = true;
    bool exempt_loopback = true;

    std::atomic<uint64_t> rx_count{0}, dropped_ring{0}, dropped_rate{0},
        dropped_martian{0}, tx_count{0};
};

bool is_martian_v4(const uint8_t* a4, uint16_t port) {
    // (network_engine.cpp:361-386): zero port, 0.0.0.0/8, 224/4
    // multicast; 127/8 is allowed for localhost operation here (the
    // reference drops it only on non-local builds)
    if (port == 0) return true;
    if (a4[0] == 0) return true;
    if (a4[0] >= 224 && a4[0] <= 239) return true;
    return false;
}

bool is_martian_v6(const uint8_t* a, uint16_t port) {
    // (network_engine.cpp:372-383): zero port, multicast ff00::/8,
    // link-local fe80::/10, the unspecified address, v4-mapped
    // ::ffff:0:0/96.  ::1 is allowed for localhost operation.
    if (port == 0) return true;
    if (a[0] == 0xFF) return true;
    if (a[0] == 0xFE && (a[1] & 0xC0) == 0x80) return true;
    static const uint8_t zeros[16] = {0};
    if (std::memcmp(a, zeros, 16) == 0) return true;
    static const uint8_t mapped[12] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                       0xFF, 0xFF};
    if (std::memcmp(a, mapped, 12) == 0) return true;
    return false;
}

bool is_loopback(uint8_t family, const uint8_t* a) {
    if (family == 4) return a[0] == 127;
    static const uint8_t v6lo[16] = {0, 0, 0, 0, 0, 0, 0, 0,
                                     0, 0, 0, 0, 0, 0, 0, 1};
    return std::memcmp(a, v6lo, 16) == 0;
}

void handle_datagram(Engine* e, uint8_t family, const uint8_t* addr,
                     uint16_t port, const uint8_t* buf, ssize_t n) {
    double now = now_s();
    bool martian = (family == 4) ? is_martian_v4(addr, port)
                                 : is_martian_v6(addr, port);
    if (e->drop_martian && martian) {
        e->dropped_martian++;
        return;
    }
    // loopback traffic is exempt from rate limiting: local clusters
    // legitimately share 127.0.0.1/::1 as the source, and the limits
    // exist for remote floods
    bool loopback = e->exempt_loopback && is_loopback(family, addr);
    {
        std::lock_guard<std::mutex> lk(e->mtx);
        if (!loopback && !e->global_limit.limit(now)) {
            e->dropped_rate++;
            return;
        }
        if (!loopback && e->per_ip_quota) {
            // bound the per-IP map: spoofed-source floods must not grow
            // memory without limit — evict idle windows once the map
            // gets large, at most once per second (an O(n) sweep per
            // packet would itself be the DoS)
            if (e->ip_limits.size() > 4096 && now - e->last_prune > 1.0) {
                e->last_prune = now;
                for (auto it = e->ip_limits.begin();
                     it != e->ip_limits.end();) {
                    auto& w2 = it->second;
                    if (w2.hits.empty() || w2.hits.back() < now - w2.period)
                        it = e->ip_limits.erase(it);
                    else
                        ++it;
                }
            }
            std::string key((const char*)addr, family == 4 ? 4 : 16);
            auto& w = e->ip_limits[key];
            if (w.quota == 0) w = RateWindow(e->per_ip_quota, 1.0);
            if (!w.limit(now)) {
                e->dropped_rate++;
                return;
            }
        }
        size_t next = (e->head + 1) % e->ring.size();
        if (next == e->tail) {                 // ring full → drop oldest
            e->tail = (e->tail + 1) % e->ring.size();
            e->dropped_ring++;
        }
        Packet& p = e->ring[e->head];
        p.rx_time = now;
        p.family = family;
        std::memset(p.addr, 0, sizeof(p.addr));
        std::memcpy(p.addr, addr, family == 4 ? 4 : 16);
        p.port = port;
        p.len = (uint16_t)n;
        std::memcpy(p.data, buf, n);
        e->head = next;
    }
    e->cv.notify_all();
    e->rx_count++;
}

void drain_fd(Engine* e, int fd) {
    for (;;) {
        sockaddr_storage from{};
        socklen_t fl = sizeof(from);
        uint8_t buf[MAX_PACKET];
        ssize_t n = recvfrom(fd, buf, sizeof(buf), MSG_DONTWAIT,
                             (sockaddr*)&from, &fl);
        if (n <= 0) break;
        if (from.ss_family == AF_INET) {
            auto* sin = (sockaddr_in*)&from;
            handle_datagram(e, 4, (const uint8_t*)&sin->sin_addr,
                            ntohs(sin->sin_port), buf, n);
        } else if (from.ss_family == AF_INET6) {
            auto* sin6 = (sockaddr_in6*)&from;
            handle_datagram(e, 6, (const uint8_t*)&sin6->sin6_addr,
                            ntohs(sin6->sin6_port), buf, n);
        }
    }
}

void rcv_loop(Engine* e) {
    struct pollfd pfds[2];
    int nfds = 0;
    pfds[nfds++] = {e->fd4, POLLIN, 0};
    if (e->fd6 >= 0) pfds[nfds++] = {e->fd6, POLLIN, 0};
    while (e->running.load(std::memory_order_relaxed)) {
        int r = poll(pfds, nfds, 100);
        if (r <= 0) continue;
        for (int i = 0; i < nfds; ++i)
            if (pfds[i].revents & POLLIN) drain_fd(e, pfds[i].fd);
    }
}

} // namespace

extern "C" {

// returns an opaque handle, or null on failure.  enable_v6 != 0 also
// binds an IPv6-only socket on the same port (best effort: v6 bind
// failure leaves a v4-only engine — check dht_udp_has_v6).
void* dht_udp_create(uint16_t port, uint32_t ring_size,
                     uint32_t global_rps, uint32_t per_ip_rps,
                     int32_t exempt_loopback, int32_t enable_v6) {
    Engine* e = new Engine();
    e->exempt_loopback = exempt_loopback != 0;
    e->fd4 = socket(AF_INET, SOCK_DGRAM, 0);
    if (e->fd4 < 0) { delete e; return nullptr; }
    int one = 1;
    setsockopt(e->fd4, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(port);
    if (bind(e->fd4, (sockaddr*)&addr, sizeof(addr)) != 0) {
        close(e->fd4);
        delete e;
        return nullptr;
    }
    socklen_t alen = sizeof(addr);
    getsockname(e->fd4, (sockaddr*)&addr, &alen);
    e->bound_port = ntohs(addr.sin_port);

    if (enable_v6) {
        e->fd6 = socket(AF_INET6, SOCK_DGRAM, 0);
        if (e->fd6 >= 0) {
            setsockopt(e->fd6, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
            setsockopt(e->fd6, IPPROTO_IPV6, IPV6_V6ONLY, &one, sizeof(one));
            sockaddr_in6 a6{};
            a6.sin6_family = AF_INET6;
            a6.sin6_addr = in6addr_any;
            a6.sin6_port = htons(e->bound_port);
            if (bind(e->fd6, (sockaddr*)&a6, sizeof(a6)) != 0) {
                close(e->fd6);
                e->fd6 = -1;
            }
        }
    }

    e->ring.resize(ring_size ? ring_size : 16384);
    // defaults mirror network_engine.h:424 (1600 global, 200 per-IP rps)
    e->global_limit = RateWindow(global_rps, 1.0);
    e->per_ip_quota = per_ip_rps;
    e->running = true;
    e->rcv = std::thread(rcv_loop, e);
    return e;
}

uint16_t dht_udp_port(void* h) { return ((Engine*)h)->bound_port; }

int32_t dht_udp_has_v6(void* h) { return ((Engine*)h)->fd6 >= 0 ? 1 : 0; }

void dht_udp_destroy(void* h) {
    Engine* e = (Engine*)h;
    e->running = false;
    if (e->rcv.joinable()) e->rcv.join();
    if (e->fd4 >= 0) close(e->fd4);
    if (e->fd6 >= 0) close(e->fd6);
    delete e;
}

// family 4: addr16's first 4 bytes; family 6: all 16 bytes.
int dht_udp_send(void* h, const uint8_t* data, uint32_t len,
                 const uint8_t* addr16, int32_t family, uint16_t port) {
    Engine* e = (Engine*)h;
    ssize_t n = -1;
    if (family == 4) {
        sockaddr_in to{};
        to.sin_family = AF_INET;
        std::memcpy(&to.sin_addr, addr16, 4);
        to.sin_port = htons(port);
        n = sendto(e->fd4, data, len, 0, (sockaddr*)&to, sizeof(to));
    } else if (family == 6 && e->fd6 >= 0) {
        sockaddr_in6 to{};
        to.sin6_family = AF_INET6;
        std::memcpy(&to.sin6_addr, addr16, 16);
        to.sin6_port = htons(port);
        n = sendto(e->fd6, data, len, 0, (sockaddr*)&to, sizeof(to));
    } else {
        return EAFNOSUPPORT;
    }
    if (n == (ssize_t)len) { e->tx_count++; return 0; }
    return errno ? errno : -1;
}

// Drain up to max_pkts packets.  Layout per packet in out:
//   f64 rx_time | u8 family | u8 addr[16] | u16 port | u16 len | u8 data[len]
// Returns the number of packets written; out_bytes receives bytes used.
int32_t dht_udp_poll(void* h, uint8_t* out, uint64_t out_cap,
                     int32_t max_pkts, uint64_t* out_bytes) {
    Engine* e = (Engine*)h;
    int32_t count = 0;
    uint64_t off = 0;
    std::lock_guard<std::mutex> lk(e->mtx);
    while (count < max_pkts && e->tail != e->head) {
        Packet& p = e->ring[e->tail];
        uint64_t need = 8 + 1 + 16 + 2 + 2 + p.len;
        if (off + need > out_cap) break;
        std::memcpy(out + off, &p.rx_time, 8); off += 8;
        out[off++] = p.family;
        std::memcpy(out + off, p.addr, 16); off += 16;
        std::memcpy(out + off, &p.port, 2); off += 2;
        std::memcpy(out + off, &p.len, 2); off += 2;
        std::memcpy(out + off, p.data, p.len); off += p.len;
        e->tail = (e->tail + 1) % e->ring.size();
        ++count;
    }
    *out_bytes = off;
    return count;
}

// has packets waiting?
int32_t dht_udp_pending(void* h) {
    Engine* e = (Engine*)h;
    std::lock_guard<std::mutex> lk(e->mtx);
    return e->tail != e->head ? 1 : 0;
}

// Block until a packet is pending or timeout_ms elapses; returns 1 if
// pending.  ctypes releases the GIL around the call, so a Python waiter
// thread can sleep here without starving the interpreter.
int32_t dht_udp_wait(void* h, int32_t timeout_ms) {
    Engine* e = (Engine*)h;
    std::unique_lock<std::mutex> lk(e->mtx);
    if (e->tail != e->head) return 1;
    e->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms));
    return e->tail != e->head ? 1 : 0;
}

void dht_udp_stats(void* h, uint64_t* out6) {
    Engine* e = (Engine*)h;
    out6[0] = e->rx_count.load();
    out6[1] = e->tx_count.load();
    out6[2] = e->dropped_ring.load();
    out6[3] = e->dropped_rate.load();
    out6[4] = e->dropped_martian.load();
    std::lock_guard<std::mutex> lk(e->mtx);
    out6[5] = (e->head + e->ring.size() - e->tail) % e->ring.size();
}

} // extern "C"
