"""Single-file management UI (replaces the reference's Vue SPA, web/ui/).

Functionally equivalent surface against the same /v1 REST API: dashboard
overview, job CRUD + pause + run-now, node list with liveness, node groups,
execution logs with filters, executing view, account administration,
profile/set-password — with en / zh-CN i18n (reference web/ui/src/i18n/).
Zero build step: one HTML string served at /ui/.

Copy of ``cronsun_tpu/web/ui.py``.
"""

INDEX_HTML = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>cronsun-tpu</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#f5f6f8;color:#222}
 header{background:#1a2733;color:#fff;padding:10px 18px;display:flex;gap:18px;align-items:center}
 header b{font-size:17px} header a{color:#cfd8e3;cursor:pointer;text-decoration:none;padding:4px 8px;border-radius:4px}
 header a.active,header a:hover{background:#2e4052;color:#fff}
 main{padding:18px;max-width:1100px;margin:auto}
 table{border-collapse:collapse;width:100%;background:#fff;box-shadow:0 1px 2px #0002}
 th,td{padding:7px 10px;border-bottom:1px solid #e7eaee;text-align:left;font-size:13.5px;vertical-align:top}
 th{background:#eef1f5} tr:hover td{background:#f7fafd}
 .ok{color:#0a7d38}.bad{color:#c0392b}.muted{color:#888}
 button{background:#2d6cdf;color:#fff;border:0;border-radius:4px;padding:5px 11px;cursor:pointer;font-size:13px}
 button.warn{background:#c0392b} button.plain{background:#7c8aa0}
 input,select,textarea{padding:6px;border:1px solid #c8d0da;border-radius:4px;font-size:13.5px}
 .cards{display:flex;gap:14px;margin-bottom:18px;flex-wrap:wrap}
 .card{background:#fff;box-shadow:0 1px 2px #0002;border-radius:6px;padding:14px 20px;min-width:130px}
 .card .n{font-size:26px;font-weight:600}.card .t{color:#778;font-size:12.5px}
 #login{max-width:320px;margin:90px auto;background:#fff;padding:26px;border-radius:8px;box-shadow:0 2px 8px #0003;display:flex;flex-direction:column;gap:10px}
 dialog{border:0;border-radius:8px;box-shadow:0 4px 20px #0005;padding:20px;min-width:520px}
 dialog label{display:block;margin:8px 0 2px;font-size:12.5px;color:#556}
 dialog input,dialog select,dialog textarea{width:100%;box-sizing:border-box}
 .row{display:flex;gap:10px}.row>*{flex:1}
 pre{white-space:pre-wrap;background:#0e1620;color:#d7e3ef;padding:10px;border-radius:6px;max-height:300px;overflow:auto}
 .bar{display:flex;gap:8px;margin-bottom:12px;align-items:center;flex-wrap:wrap}
 /* popover: joins the browser top layer so toasts paint above open
    showModal() dialogs (a plain z-index never can) */
 #toasts{position:fixed;inset:auto 14px auto auto;top:14px;margin:0;padding:0;
  border:0;background:transparent;overflow:visible;
  display:flex;flex-direction:column;gap:8px}
 .toast{padding:9px 14px;border-radius:6px;color:#fff;box-shadow:0 2px 8px #0004;
  font-size:13.5px;max-width:340px;animation:fadein .15s}
 .toast.ok{background:#0a7d38}.toast.err{background:#c0392b}
 @keyframes fadein{from{opacity:0;transform:translateY(-6px)}to{opacity:1}}
</style></head><body>
<header><b>cronsun-tpu</b>
 <a data-v=dash></a><a data-v=jobs></a><a data-v=nodes></a>
 <a data-v=groups></a><a data-v=logs></a><a data-v=exec></a>
 <a data-v=accounts id=nav-acc style="display:none"></a>
 <span style="flex:1"></span><a data-v=profile id=who class=muted></a>
 <a id=langbtn title="language"></a><a id=logout></a>
</header>
<main id=main></main>
<div id=toasts popover=manual></div>
<script>
const $=s=>document.querySelector(s);
// non-blocking notifications (the reference's Messager component)
function toast(msg,ok){const c=$('#toasts');const d=document.createElement('div');
 d.className='toast '+(ok?'ok':'err');d.textContent=String(msg);
 c.appendChild(d);try{c.showPopover()}catch(e){}
 setTimeout(()=>{d.remove();if(!c.children.length){try{c.hidePopover()}catch(e){}}},
  ok?2500:6000)}
// ---- i18n (reference: web/ui/src/i18n/ en + zh-CN) ----
const L={en:{
 dash:'Dashboard',jobs:'Jobs',nodes:'Nodes',groups:'Groups',logs:'Logs',
 exec:'Executing',accounts:'Accounts',logout:'logout',signin:'Sign in',
 email:'email',password:'password',loginBtn:'Login',
 cJobs:'jobs',cAlive:'nodes alive',cExecs:'executions',cOk:'succeeded',cFail:'failed',
 daily:'Daily',day:'day',total:'total',success:'success',failed:'failed',
 newJob:'+ New job',name:'name',group:'group',command:'command',kind:'kind',
 timers:'timers',status:'status',edit:'edit',del:'del',run:'run',
 pause:'pause',resume:'resume',paused:'paused',active:'active',
 hostname:'hostname',version:'version',upSince:'up since',connected:'connected',down:'down',
 newGroup:'+ New group',nodesCol:'nodes',
 failedOnly:'failed only',records:'records',job:'job',node:'node',begin:'begin',
 secs:'secs',output:'output',since:'since',nothingRunning:'nothing running',
 newAccount:'+ New account',role:'role',builtIn:'built-in',enabled:'enabled',banned:'banned',
 admin:'Administrator',dev:'Developer',
 profile:'Profile',curPw:'current password',newPw:'new password',
 repPw:'repeat new password',changePw:'Change password',
 pwDiffer:'passwords differ',pwChanged:'password changed',
 editT:'Edit',newT:'New',account:'account',save:'Save',cancel:'Cancel',
 keepEmpty:'(leave empty to keep)',
 kCommon:'Common (all eligible nodes)',kAlone:'Alone (exactly one)',
 kInterval:'Interval (one per interval)',user:'user',timeoutS:'timeout s',
 retry:'retry',parallels:'parallels',
 jitterS:'jitter s (0-300, smears herd)',
 cronTimer:'cron timer (sec min hour dom month dow)',
 nodeIds:'node ids (comma)',groupIds:'group ids',excludeNodes:'exclude nodes',
 delJobQ:'delete job?',delGroupQ:'delete group?',dispatched:'dispatched',
 allNodes:'all eligible nodes',
 addTimer:'+ timer',removeTimer:'remove',timerN:'timer',
 fltName:'name contains',fltNode:'node',fltFrom:'from',fltTo:'to',
 apply:'Apply',clearF:'Clear',
 planner:'Planner',instance:'instance',leaderCol:'leader',
 queueDepth:'queue',overflow:'overflow',watchLoss:'watch loss',
},zh:{
 dash:'仪表盘',jobs:'任务',nodes:'节点',groups:'节点分组',logs:'执行日志',
 exec:'正在执行',accounts:'账户',logout:'退出',signin:'登录',
 email:'邮箱',password:'密码',loginBtn:'登录',
 cJobs:'任务数',cAlive:'在线节点',cExecs:'执行次数',cOk:'成功',cFail:'失败',
 daily:'每日统计',day:'日期',total:'总数',success:'成功',failed:'失败',
 newJob:'+ 新建任务',name:'名称',group:'分组',command:'命令',kind:'类型',
 timers:'定时器',status:'状态',edit:'编辑',del:'删除',run:'执行',
 pause:'暂停',resume:'恢复',paused:'已暂停',active:'启用',
 hostname:'主机名',version:'版本',upSince:'启动时间',connected:'在线',down:'离线',
 newGroup:'+ 新建分组',nodesCol:'节点',
 failedOnly:'只看失败',records:'条记录',job:'任务',node:'节点',begin:'开始时间',
 secs:'耗时(秒)',output:'输出',since:'开始于',nothingRunning:'没有正在执行的任务',
 newAccount:'+ 新建账户',role:'角色',builtIn:'内置',enabled:'启用',banned:'禁用',
 admin:'管理员',dev:'开发者',
 profile:'个人资料',curPw:'当前密码',newPw:'新密码',
 repPw:'重复新密码',changePw:'修改密码',
 pwDiffer:'两次输入的密码不一致',pwChanged:'密码已修改',
 editT:'编辑',newT:'新建',account:'账户',save:'保存',cancel:'取消',
 keepEmpty:'（留空保持不变）',
 kCommon:'普通（所有可选节点执行）',kAlone:'单机（只在一个节点执行）',
 kInterval:'间隔（每个间隔一次）',user:'用户',timeoutS:'超时(秒)',
 retry:'重试次数',parallels:'并发上限',
 jitterS:'抖动秒数（0-300，打散同秒任务）',
 cronTimer:'cron 定时器（秒 分 时 日 月 周）',
 nodeIds:'节点 ID（逗号分隔）',groupIds:'分组 ID',excludeNodes:'排除节点',
 delJobQ:'确定删除该任务？',delGroupQ:'确定删除该分组？',dispatched:'已派发',
 allNodes:'所有可选节点',
 addTimer:'+ 定时器',removeTimer:'删除',timerN:'定时器',
 fltName:'名称包含',fltNode:'节点',fltFrom:'开始',fltTo:'结束',
 apply:'筛选',clearF:'清除',
 planner:'调度器',instance:'实例',leaderCol:'主节点',
 queueDepth:'队列',overflow:'溢出',watchLoss:'监听丢失',
}};
let lang=localStorage.lang||'en';
const t=k=>(L[lang]&&L[lang][k])||L.en[k]||k;
function chrome(){document.querySelectorAll('header a[data-v]').forEach(a=>{
  if(a.id!=='who')a.textContent=t(a.dataset.v)});
 $('#langbtn').textContent=lang==='en'?'中文':'EN';
 $('#logout').textContent=t('logout')}
$('#langbtn').onclick=()=>{lang=lang==='en'?'zh':'en';localStorage.lang=lang;
 chrome();render[view]?nav(view):login()};
// ---- plumbing ----
const api=async(m,p,b)=>{const r=await fetch(p,{method:m,headers:{'Content-Type':'application/json'},
  body:b?JSON.stringify(b):undefined});const d=await r.json().catch(()=>({}));
  if(r.status===401){login();throw 'auth'}if(!r.ok)throw (d.error||r.status);return d};
const esc=s=>String(s??'').replace(/[&<>"]/g,c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;'}[c]));
const ts=t=>t?new Date(t*1000).toLocaleString():'';
let view='dash',me={};
function login(){$('#main').innerHTML=`<form id=login>
 <b>${t('signin')}</b><input id=em placeholder="${t('email')}" value="admin@admin.com">
 <input id=pw type=password placeholder="${t('password')}" value="admin">
 <button>${t('loginBtn')}</button><span id=err class=bad></span></form>`;
 $('#login').onsubmit=async e=>{e.preventDefault();try{
  const d=await api('POST','/v1/session',{email:$('#em').value,password:$('#pw').value});
  me=d;$('#who').textContent=d.email;$('#nav-acc').style.display=d.role===1?'':'none';
  nav(view)}catch(x){$('#err').textContent=x}}}
$('#logout').onclick=async()=>{await api('DELETE','/v1/session');login()};
document.querySelectorAll('header a[data-v]').forEach(a=>a.onclick=()=>nav(a.dataset.v));
function nav(v){view=v;document.querySelectorAll('header a[data-v]').forEach(a=>
 a.classList.toggle('active',a.dataset.v===v));render[v]().catch(e=>{if(e!=='auth')$('#main').innerHTML='<p class=bad>'+esc(e)+'</p>'})}
const render={
 async dash(){const o=await api('GET','/v1/info/overview');
  const sch=Object.entries(o.schedulers||{});
  $('#main').innerHTML=`<div class=cards>
   <div class=card><div class=n>${o.totalJobs}</div><div class=t>${t('cJobs')}</div></div>
   <div class=card><div class=n>${o.nodeAlived}</div><div class=t>${t('cAlive')}</div></div>
   <div class=card><div class=n>${o.jobExecuted.total}</div><div class=t>${t('cExecs')}</div></div>
   <div class=card><div class=n class=ok>${o.jobExecuted.successed}</div><div class=t>${t('cOk')}</div></div>
   <div class=card><div class=n class=bad>${o.jobExecuted.failed}</div><div class=t>${t('cFail')}</div></div></div>
  ${sch.length?`<h3>${t('planner')}</h3><table>
   <tr><th>${t('instance')}</th><th>${t('leaderCol')}</th><th>tick p50/p99 (ms)</th><th>${t('dispatched')}</th><th>${t('queueDepth')}</th><th>${t('overflow')}</th><th>${t('watchLoss')}</th></tr>
   ${sch.map(([id,s])=>`<tr><td>${esc(id)}</td>
    <td>${s.is_leader?`<span class=ok>✓</span>`:`<span class=muted>standby</span>`}</td>
    <td>${esc(s.tick_p50_ms)} / ${esc(s.tick_p99_ms)}</td><td>${esc(s.dispatches_total)}</td>
    <td>${esc(s.dispatch_queue_depth)}</td><td>${esc(s.overflow_drops_total)}</td>
    <td>${esc(s.watch_losses_total)}</td></tr>`).join('')}</table>`:''}
  <h3>${t('daily')}</h3><table><tr><th>${t('day')}</th><th>${t('total')}</th><th>${t('success')}</th><th>${t('failed')}</th></tr>
  ${o.jobExecutedDaily.map(d=>`<tr><td>${d.day}</td><td>${d.total}</td><td class=ok>${d.successed}</td><td class=bad>${d.failed}</td></tr>`).join('')}</table>`},
 async jobs(){const js=await api('GET','/v1/jobs');window._jobs=js;
  // row actions reference rows by index (never interpolate user-controlled
  // ids/groups into JS-string context: a quote in a group name was stored XSS)
  $('#main').innerHTML=`<div class=bar><button onclick="editJob()">${t('newJob')}</button></div>
  <table><tr><th>${t('name')}</th><th>${t('group')}</th><th>${t('command')}</th><th>${t('kind')}</th><th>${t('timers')}</th><th>${t('status')}</th><th></th></tr>
  ${js.map((j,i)=>`<tr><td>${esc(j.name)}</td><td>${esc(j.group)}</td><td><code>${esc(j.command)}</code></td>
   <td>${['Common','Alone','Interval'][j.kind]||j.kind}</td>
   <td>${(j.rules||[]).map(r=>esc(r.timer)).join('<br>')}${j.jitter?`<br><span class=muted>±${+j.jitter}s</span>`:''}</td>
   <td>${j.pause?`<span class=muted>${t('paused')}</span>`:`<span class=ok>${t('active')}</span>`}</td>
   <td><button class=plain onclick="editJob(_jobs[${i}])">${t('edit')}</button>
    <button class=plain onclick="toggleJob(${i})">${j.pause?t('resume'):t('pause')}</button>
    <button onclick="runNow(${i})">${t('run')}</button>
    <button class=warn onclick="delJob(${i})">${t('del')}</button></td></tr>`).join('')}</table>`},
 async nodes(){const ns=await api('GET','/v1/nodes');
  $('#main').innerHTML=`<table><tr><th>id</th><th>${t('hostname')}</th><th>pid</th><th>${t('version')}</th><th>${t('upSince')}</th><th>${t('status')}</th></tr>
  ${ns.map(n=>`<tr><td>${esc(n.id)}</td><td>${esc(n.hostname)}</td><td>${n.pid}</td><td>${esc(n.version)}</td>
   <td>${ts(n.up_ts)}</td><td>${n.connected?`<span class=ok>${t('connected')}</span>`:`<span class=bad>${t('down')}</span>`}</td></tr>`).join('')}</table>`},
 async groups(){const gs=await api('GET','/v1/node/groups');window._groups=gs;
  $('#main').innerHTML=`<div class=bar><button onclick="editGroup()">${t('newGroup')}</button></div>
  <table><tr><th>id</th><th>${t('name')}</th><th>${t('nodesCol')}</th><th></th></tr>
  ${gs.map((g,i)=>`<tr><td>${esc(g.id)}</td><td>${esc(g.name)}</td><td>${(g.nids||[]).map(esc).join(', ')}</td>
   <td><button class=plain onclick="editGroup(_groups[${i}])">${t('edit')}</button>
   <button class=warn onclick="delGroup(${i})">${t('del')}</button></td></tr>`).join('')}</table>`},
 async logs(){
  // filter state persists across renders (reference Log.vue filters:
  // node / name regex / time window / failedOnly, web/job_log.go:18-113)
  const F=window._logF=window._logF||{};
  const page=window._logPage||1,PS=50;
  const q=[`pageSize=${PS}`,`page=${page}`];
  if(F.failed)q.push('failedOnly=true');
  if(F.node)q.push('node='+encodeURIComponent(F.node));
  if(F.names)q.push('names='+encodeURIComponent(F.names));
  if(F.begin)q.push('begin='+(new Date(F.begin).getTime()/1000));
  if(F.end)q.push('end='+(new Date(F.end).getTime()/1000));
  const d=await api('GET','/v1/logs?'+q.join('&'));
  const pages=Math.max(1,Math.ceil(d.total/PS));
  $('#main').innerHTML=`<div class=bar>
   <input id=fn placeholder="${t('fltName')}" value="${esc(F.names||'')}" style="width:130px">
   <input id=fd placeholder="${t('fltNode')}" value="${esc(F.node||'')}" style="width:110px">
   <label class=muted>${t('fltFrom')}</label><input id=fb type=datetime-local value="${esc(F.begin||'')}">
   <label class=muted>${t('fltTo')}</label><input id=fe type=datetime-local value="${esc(F.end||'')}">
   <label><input type=checkbox id=flt ${F.failed?'checked':''}> ${t('failedOnly')}</label>
   <button id=fapply>${t('apply')}</button><button class=plain id=fclear>${t('clearF')}</button>
   <span class=muted>${d.total} ${t('records')}</span><span style="flex:1"></span>
   <button class=plain ${page<=1?'disabled':''} onclick="window._logPage=${page-1};nav('logs')">‹</button>
   <span class=muted>${page} / ${pages}</span>
   <button class=plain ${page>=pages?'disabled':''} onclick="window._logPage=${page+1};nav('logs')">›</button></div>
  <table><tr><th>${t('job')}</th><th>${t('node')}</th><th>${t('begin')}</th><th>${t('secs')}</th><th>ok</th><th>${t('output')}</th></tr>
  ${d.list.map(l=>`<tr style=cursor:pointer onclick="logDetail(${l.id})"><td>${esc(l.name)}</td><td>${esc(l.node)}</td><td>${ts(l.beginTime)}</td>
   <td>${(l.endTime-l.beginTime).toFixed(1)}</td>
   <td>${l.success?'<span class=ok>✓</span>':'<span class=bad>✗</span>'}</td>
   <td><code>${esc((l.output||'').slice(0,160))}</code></td></tr>`).join('')}</table>`;
  $('#fapply').onclick=()=>{window._logF={names:$('#fn').value,node:$('#fd').value,
   begin:$('#fb').value,end:$('#fe').value,failed:$('#flt').checked};
   window._logPage=1;nav('logs')};
  $('#fclear').onclick=()=>{window._logF={};window._logPage=1;nav('logs')}},
 async exec(){const xs=await api('GET','/v1/job/executing');
  $('#main').innerHTML=`<table><tr><th>${t('node')}</th><th>${t('group')}</th><th>${t('job')}</th><th>pid</th><th>${t('since')}</th></tr>
  ${xs.map(x=>`<tr><td>${esc(x.node)}</td><td>${esc(x.group)}</td><td>${esc(x.jobId)}</td>
   <td>${esc(x.pid)}</td><td>${ts(x.time)}</td></tr>`).join('')||`<tr><td colspan=5 class=muted>${t('nothingRunning')}</td></tr>`}</table>`},
 async accounts(){const as=await api('GET','/v1/admin/accounts');window._accts=as;
  $('#main').innerHTML=`<div class=bar><button onclick="editAccount()">${t('newAccount')}</button></div>
  <table><tr><th>${t('email')}</th><th>${t('role')}</th><th>${t('status')}</th><th></th></tr>
  ${as.map((a,i)=>`<tr><td>${esc(a.email)}${a.unchangeable?` <span class=muted>(${t('builtIn')})</span>`:''}</td>
   <td>${a.role===1?t('admin'):t('dev')}</td>
   <td>${a.status===1?`<span class=ok>${t('enabled')}</span>`:`<span class=bad>${t('banned')}</span>`}</td>
   <td><button class=plain onclick="editAccount(_accts[${i}])">${t('edit')}</button></td></tr>`).join('')}</table>`},
 async profile(){
  $('#main').innerHTML=`<h3>${t('profile')} — ${esc(me.email||'')}</h3>
  <form id=pf style="max-width:340px;display:flex;flex-direction:column;gap:8px;background:#fff;padding:18px;border-radius:8px;box-shadow:0 1px 2px #0002">
   <label>${t('curPw')}</label><input id=po type=password>
   <label>${t('newPw')}</label><input id=pn type=password>
   <label>${t('repPw')}</label><input id=pn2 type=password>
   <button>${t('changePw')}</button><span id=pmsg></span></form>`;
  $('#pf').onsubmit=async e=>{e.preventDefault();const m=$('#pmsg');
   if($('#pn').value!==$('#pn2').value){m.className='bad';m.textContent=t('pwDiffer');return}
   try{await api('POST','/v1/user/setpwd',{password:$('#po').value,newPassword:$('#pn').value});
    m.className='ok';m.textContent=t('pwChanged')}catch(x){m.className='bad';m.textContent=x}}},
};
window.editAccount=(a)=>{a=a||{};
 document.body.insertAdjacentHTML('beforeend',`<dialog id=dlg><form method=dialog>
  <b>${a.email?t('editT'):t('newT')} ${t('account')}</b>
  <label>${t('email')}</label><input id=ae value="${esc(a.email||'')}" ${a.email?'disabled':''}>
  <div class=row><div><label>${t('role')}</label><select id=ar>
    <option value=2 ${a.role!==1?'selected':''}>${t('dev')}</option>
    <option value=1 ${a.role===1?'selected':''}>${t('admin')}</option></select></div>
  <div><label>${t('status')}</label><select id=as_>
    <option value=1 ${a.status!==0?'selected':''}>${t('enabled')}</option>
    <option value=0 ${a.status===0?'selected':''}>${t('banned')}</option></select></div></div>
  <label>${t('password')} ${a.email?t('keepEmpty'):''}</label><input id=ap type=password>
  <div class=bar style="margin-top:14px"><button id=sv>${t('save')}</button><button class=plain>${t('cancel')}</button></div>
 </form></dialog>`);const dlg=$('#dlg');dlg.showModal();dlg.onclose=()=>dlg.remove();
 $('#sv').onclick=async e=>{e.preventDefault();try{
  const body={email:a.email||$('#ae').value,role:+$('#ar').value,status:+$('#as_').value};
  if($('#ap').value)body.password=$('#ap').value;
  await api(a.email?'POST':'PUT','/v1/admin/account',body);
  dlg.close();nav('accounts')}catch(x){toast(x)}}};
window.logDetail=async id=>{const l=await api('GET','/v1/log/'+id);
 document.body.insertAdjacentHTML('beforeend',`<dialog id=dlg>
  <b>${esc(l.name)}</b> <span class=muted>@ ${esc(l.node)} · ${ts(l.beginTime)} · ${(l.endTime-l.beginTime).toFixed(2)}s ·
  ${l.success?`<span class=ok>✓</span>`:`<span class=bad>✗</span>`}</span>
  <p><code>${esc(l.command)}</code></p><pre>${esc(l.output||'')}</pre>
  <div class=bar style="margin-top:10px"><form method=dialog><button class=plain>${t('cancel')}</button></form></div>
 </dialog>`);const dlg=$('#dlg');dlg.showModal();dlg.onclose=()=>dlg.remove()};
window.toggleJob=async i=>{const j=_jobs[i];
 await api('POST',`/v1/job/${encodeURIComponent(j.group)}-${encodeURIComponent(j.id)}`,{pause:!j.pause});nav('jobs')};
window.runNow=async i=>{const j=_jobs[i],
 key=`${encodeURIComponent(j.group)}-${encodeURIComponent(j.id)}`;
 const ns=await api('GET',`/v1/job/${key}/nodes`);
 document.body.insertAdjacentHTML('beforeend',`<dialog id=dlg>
  <b>${t('run')}</b>
  <label>${t('node')}</label><select id=xn><option value="">${t('allNodes')}</option>
  ${ns.map(n=>`<option>${esc(n)}</option>`).join('')}</select>
  <div class=bar style="margin-top:14px"><button id=sv>${t('run')}</button>
  <form method=dialog style=display:inline><button class=plain>${t('cancel')}</button></form></div>
 </dialog>`);const dlg=$('#dlg');dlg.showModal();dlg.onclose=()=>dlg.remove();
 $('#sv').onclick=async e=>{e.preventDefault();try{
  await api('PUT',`/v1/job/${key}/execute?node=`+encodeURIComponent($('#xn').value));
  dlg.close();toast(t('dispatched'),true)}catch(x){toast(x)}}};
window.delJob=async i=>{const j=_jobs[i];if(confirm(t('delJobQ'))){
 await api('DELETE',`/v1/job/${encodeURIComponent(j.group)}-${encodeURIComponent(j.id)}`);nav('jobs')}};
window.delGroup=async i=>{const g=_groups[i];if(confirm(t('delGroupQ'))){
 await api('DELETE','/v1/node/group/'+encodeURIComponent(g.id));nav('groups')}};
// Multi-rule job editor (reference JobEditRule.vue edits a LIST of rules per
// job, web/ui/src/components/JobEdit.vue): every rule renders as its own
// timer/nids/gids/exclude row with add/remove; saving collects all rows —
// editing a >=2-rule job must never drop rules.
window.editJob=(j)=>{j=j||{};
 const rules=(j.rules&&j.rules.length?j.rules:[{}]).map(r=>({...r}));
 const ruleRow=(r,k)=>`<fieldset style="border:1px solid #dde;border-radius:6px;margin:8px 0;padding:4px 10px 10px">
  <legend class=muted style="font-size:12px">${t('timerN')} ${k+1}
   <a style="cursor:pointer;color:#c0392b" data-rm=${k}>✕ ${t('removeTimer')}</a></legend>
  <label>${t('cronTimer')}</label><input data-rt=${k} value="${esc(r.timer||'0 */5 * * * *')}">
  <div class=row><div><label>${t('nodeIds')}</label><input data-rn=${k} value="${esc((r.nids||[]).join(','))}"></div>
  <div><label>${t('groupIds')}</label><input data-rg=${k} value="${esc((r.gids||[]).join(','))}"></div>
  <div><label>${t('excludeNodes')}</label><input data-rx=${k} value="${esc((r.exclude_nids||[]).join(','))}"></div></div>
 </fieldset>`;
 document.body.insertAdjacentHTML('beforeend',`<dialog id=dlg><form method=dialog>
  <b>${j.id?t('editT'):t('newT')} ${t('job')}</b>
  <div class=row><div><label>${t('name')}</label><input id=jn value="${esc(j.name||'')}"></div>
  <div><label>${t('group')}</label><input id=jg value="${esc(j.group||'default')}"></div></div>
  <label>${t('command')}</label><textarea id=jc rows=2>${esc(j.command||'')}</textarea>
  <div class=row><div><label>${t('kind')}</label><select id=jk>
    <option value=0 ${j.kind==0?'selected':''}>${t('kCommon')}</option>
    <option value=1 ${j.kind==1?'selected':''}>${t('kAlone')}</option>
    <option value=2 ${j.kind==2?'selected':''}>${t('kInterval')}</option></select></div>
  <div><label>${t('user')}</label><input id=ju value="${esc(j.user||'')}"></div></div>
  <div class=row><div><label>${t('timeoutS')}</label><input id=jt type=number value="${j.timeout||0}"></div>
  <div><label>${t('retry')}</label><input id=jr type=number value="${j.retry||0}"></div>
  <div><label>${t('parallels')}</label><input id=jp type=number value="${j.parallels||0}"></div>
  <div><label>${t('jitterS')}</label><input id=jj type=number min=0 max=300 value="${j.jitter||0}"></div></div>
  <div id=rules></div>
  <button class=plain id=addr style="margin-top:4px">${t('addTimer')}</button>
  <div class=bar style="margin-top:14px"><button id=sv>${t('save')}</button><button class=plain>${t('cancel')}</button></div>
 </form></dialog>`);const dlg=$('#dlg');dlg.showModal();dlg.onclose=()=>dlg.remove();
 const csv=v=>v.split(',').map(s=>s.trim()).filter(Boolean);
 const harvest=()=>{rules.forEach((r,k)=>{const f=s=>dlg.querySelector(`[data-${s}="${k}"]`);
  if(!f('rt'))return;
  r.timer=f('rt').value;r.nids=csv(f('rn').value);
  r.gids=csv(f('rg').value);r.exclude_nids=csv(f('rx').value)})};
 const paint=()=>{ $('#rules').innerHTML=rules.map(ruleRow).join('');
  dlg.querySelectorAll('[data-rm]').forEach(a=>a.onclick=e=>{e.preventDefault();
   harvest();rules.splice(+a.dataset.rm,1);if(!rules.length)rules.push({});paint()})};
 paint();
 $('#addr').onclick=e=>{e.preventDefault();harvest();rules.push({});paint()};
 $('#sv').onclick=async e=>{e.preventDefault();harvest();
  try{await api('PUT','/v1/job',{id:j.id,name:$('#jn').value,group:$('#jg').value,oldGroup:j.group,
   command:$('#jc').value,kind:+$('#jk').value,user:$('#ju').value,timeout:+$('#jt').value,
   retry:+$('#jr').value,parallels:+$('#jp').value,jitter:+$('#jj').value,pause:!!j.pause,
   rules:rules.map(r=>({id:r.id,timer:r.timer,nids:r.nids||[],gids:r.gids||[],
           exclude_nids:r.exclude_nids||[]}))});dlg.close();nav('jobs')}catch(x){toast(x)}}};
window.editGroup=(g)=>{g=g||{};
 document.body.insertAdjacentHTML('beforeend',`<dialog id=dlg><form method=dialog>
  <b>${g.id?t('editT'):t('newT')} ${t('group')}</b>
  <label>${t('name')}</label><input id=gn value="${esc(g.name||'')}">
  <label>${t('nodeIds')}</label><input id=gm value="${esc((g.nids||[]).join(','))}">
  <div class=bar style="margin-top:14px"><button id=sv>${t('save')}</button><button class=plain>${t('cancel')}</button></div>
 </form></dialog>`);const dlg=$('#dlg');dlg.showModal();dlg.onclose=()=>dlg.remove();
 $('#sv').onclick=async e=>{e.preventDefault();try{
  await api('PUT','/v1/node/group',{id:g.id,name:$('#gn').value,
   nids:$('#gm').value.split(',').map(s=>s.trim()).filter(Boolean)});dlg.close();nav('groups')}catch(x){toast(x)}}};
chrome();
api('GET','/v1/session/me').then(d=>{me=d;$('#who').textContent=d.email;
 $('#nav-acc').style.display=d.role===1?'':'none';nav('dash')}).catch(()=>login());
</script></body></html>
"""
